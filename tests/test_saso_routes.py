"""Wide-SASO routes (ops/coo_apply.py): one-hot panels + GEMM and
per-slot segment-sums against the densified oracle, the per-backend
route table (skge.SASO_ROUTE) and the dispatch wiring."""

import jax.numpy as jnp
import numpy as np
import pytest

import randblas_tpu as rb
from randblas_tpu import skge
from randblas_tpu.ops import coo_apply
from randblas_tpu.ops.coo_apply import fixed_nnz_left_apply, \
    onehot_panel_apply

ROUTES = {"onehot": onehot_panel_apply, "segsum": fixed_nnz_left_apply}


def _case(d, m, n, k, seed, route, alpha=1.0):
    S = rb.SparseSkOp(rb.SparseDist(d, m, vec_nnz=k),
                      rb.RNGState.from_key(seed))
    s = S.filled()
    A = jnp.asarray(np.random.default_rng(seed).normal(
        size=(m, n)).astype(np.float32))
    got = np.asarray(ROUTES[route](s.rows.reshape(m, k),
                                   s.vals.reshape(m, k), A, d, alpha))
    want = alpha * (np.asarray(S.materialize(), np.float64)
                    @ np.asarray(A, np.float64))
    tol = 8 * np.finfo(np.float32).eps * k * np.abs(A).max() \
        * abs(alpha) + 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=float(tol))
    return S, A, got


@pytest.fixture
def backend_is(monkeypatch):
    """Pretend JAX's default backend is the given platform."""
    def set_platform(name):
        monkeypatch.setattr(rb.backend, "platform", lambda: name)
    return set_platform


@pytest.fixture
def route_spy(monkeypatch):
    """Record which wide-SASO route the dispatch calls."""
    calls = []
    for name, fn in (("onehot", "onehot_panel_apply"),
                     ("segsum", "fixed_nnz_left_apply")):
        orig = getattr(coo_apply, fn)
        monkeypatch.setattr(
            coo_apply, fn,
            lambda *a, _n=name, _o=orig, **kw: calls.append(_n)
            or _o(*a, **kw))
    return calls


@pytest.mark.parametrize("route", ["onehot", "segsum"])
@pytest.mark.parametrize("d,m,n,k", [
    (1024, 4096, 256, 8),     # config-3-like, aligned
    (100, 777, 65, 8),        # everything ragged
    (60, 500, 33, 3),         # d < one panel
    (1000, 2048, 129, 16),    # many slots, ragged n
    (513, 4096, 7, 1),        # single slot, skinny operand
])
def test_route_matches_oracle(d, m, n, k, route):
    _case(d, m, n, k, seed=d + k, route=route)


@pytest.mark.parametrize("route", ["onehot", "segsum"])
def test_route_alpha(route):
    _case(256, 2048, 64, 8, seed=9, route=route, alpha=-0.75)


def test_route_table():
    """One route per backend: the GPU takes the faster route measured
    on the H100 at config 3's shape (PERF.md), the CPU the segment-sums;
    an unknown backend falls back to the segment-sums."""
    assert skge.SASO_ROUTE == {"gpu": "onehot", "cpu": "segsum"}


@pytest.mark.parametrize("platform,route", [("gpu", "onehot"),
                                            ("cpu", "segsum"),
                                            ("rocm", "segsum")])
def test_dispatch_routes_wide_saso_by_backend(platform, route, backend_is,
                                              route_spy):
    """sketch_general's wide full-SASO branch takes the backend's route
    (no GPU code runs: both routes are plain XLA)."""
    backend_is(platform)
    d, m, n, k = 128, 1024, 64, 8
    S = rb.SparseSkOp(rb.SparseDist(d, m, vec_nnz=k),
                      rb.RNGState.from_key(4))
    A = jnp.asarray(np.random.default_rng(4).normal(
        size=(m, n)).astype(np.float32))
    got = np.asarray(rb.sketch_general(S, A))
    assert route_spy == [route]
    want = np.asarray(S.materialize()) @ np.asarray(A)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_dispatch_submatrix_stays_on_coo_path(route_spy):
    """Submatrix views must NOT take the wide routes (their tables are
    the full canonical per-column structure)."""
    d, m = 64, 512
    S = rb.SparseSkOp(rb.SparseDist(d, m, vec_nnz=4),
                      rb.RNGState.from_key(5))
    A = jnp.asarray(np.random.default_rng(5).normal(
        size=(256, 16)).astype(np.float32))
    got = np.asarray(rb.sketch_general(S, A, d=32, ro_s=8, co_s=100))
    assert not route_spy
    want = np.asarray(S.materialize())[8:40, 100:356] @ np.asarray(A)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


class TestTransFastPaths:
    """Right-sketch reduction (op_s == Trans full operator): S^T of a
    tall-Short SASO is wide (fixed nnz per column -> the wide routes);
    S^T of a wide-Short SASO is tall (pure gather)."""

    def test_right_sketch_tall_saso_matches_oracle(self):
        m, d, k = 2048, 96, 8
        S = rb.SparseSkOp(rb.SparseDist(m, d, vec_nnz=k),
                          rb.RNGState.from_key(6))
        A = jnp.asarray(np.random.default_rng(6).normal(
            size=(32, m)).astype(np.float32))
        got = np.asarray(rb.sketch_general(S, A, side="right"))
        want = np.asarray(A) @ np.asarray(S.materialize())
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    def test_right_sketch_tall_saso_kernel_route(self, backend_is,
                                                 route_spy):
        """The transposed full operator reaches the backend's wide route
        too (the GPU's one-hot panels here)."""
        backend_is("gpu")
        m, d, k = 1024, 64, 4
        S = rb.SparseSkOp(rb.SparseDist(m, d, vec_nnz=k),
                          rb.RNGState.from_key(7))
        A = jnp.asarray(np.random.default_rng(7).normal(
            size=(16, m)).astype(np.float32))
        got = np.asarray(rb.sketch_general(S, A, side="right"))
        assert route_spy == ["onehot"]
        want = np.asarray(A) @ np.asarray(S.materialize())
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    def test_right_sketch_wide_saso_gather(self):
        m, d, k = 64, 512, 4   # wide S: right sketch LIFTS columns
        S = rb.SparseSkOp(rb.SparseDist(m, d, vec_nnz=k),
                          rb.RNGState.from_key(8))
        A = jnp.asarray(np.random.default_rng(8).normal(
            size=(16, m)).astype(np.float32))
        got = np.asarray(rb.sketch_general(S, A, side="right"))
        want = np.asarray(A) @ np.asarray(S.materialize())
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    def test_left_trans_equals_right(self):
        # left sketch with op_s='T' hits the same trans_full branch
        m, d, k = 512, 48, 8
        S = rb.SparseSkOp(rb.SparseDist(m, d, vec_nnz=k),
                          rb.RNGState.from_key(9))
        A = jnp.asarray(np.random.default_rng(9).normal(
            size=(m, 24)).astype(np.float32))
        got = np.asarray(rb.sketch_general(S, A, op_s="T"))
        want = np.asarray(S.materialize()).T @ np.asarray(A)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("route", ["onehot", "segsum"])
def test_out_of_window_indices_dropped(route):
    """Index -1 (the distributed shard body's out-of-window marker)
    contributes nothing on either route."""
    idx = jnp.asarray([[0, -1], [-1, 2], [1, 1]], jnp.int32)
    w = jnp.asarray([[1.0, 5.0], [7.0, -1.0], [2.0, 3.0]], jnp.float32)
    b = jnp.eye(3, dtype=jnp.float32)
    got = np.asarray(ROUTES[route](idx, w, b, 3))
    want = np.zeros((3, 3), np.float32)
    want[0, 0], want[2, 1], want[1, 2] = 1.0, -1.0, 5.0
    np.testing.assert_array_equal(got, want)
