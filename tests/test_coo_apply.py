"""Unit tests for ops/coo_apply.py — the three general-COO apply
strategies (gather+segment-sum, one-shot densify, densify-panels) and
the auto dispatch between them.

Counterpart of the reference's COO kernel tests
(test/test_matmul_cores/test_spmm/test_spmm_coo.cc): every strategy is
checked against a densify+matmul numpy oracle, over submatrix windows
and alpha scales.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from randblas_tpu.ops import coo_apply


def _mk(nnz, n_rows, n_cols, n, seed=0, dup=False):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, nnz).astype(np.int32)
    cols = rng.integers(0, n_cols, nnz).astype(np.int32)
    if dup:  # force index collisions: scatter-add order independence
        rows[: nnz // 2] = rows[nnz // 2: nnz // 2 * 2]
        cols[: nnz // 2] = cols[nnz // 2: nnz // 2 * 2]
    vals = rng.normal(size=nnz).astype(np.float32)
    b = rng.normal(size=(n_cols, n)).astype(np.float32)
    return rows, cols, vals, b


def _oracle(rows, cols, vals, b, d, m, ro, co, alpha):
    dense = np.zeros((d, m), np.float32)
    keep = ((rows >= ro) & (rows < ro + d) &
            (cols >= co) & (cols < co + m))
    np.add.at(dense, (rows[keep] - ro, cols[keep] - co), vals[keep])
    return alpha * (dense @ b)


@pytest.mark.parametrize("fn", [coo_apply.coo_left_apply,
                                coo_apply.coo_left_apply_dense,
                                coo_apply.coo_left_apply_panels])
@pytest.mark.parametrize("dup", [False, True])
def test_variants_match_oracle_full(fn, dup):
    rows, cols, vals, b = _mk(600, 37, 53, 17, seed=1, dup=dup)
    want = _oracle(rows, cols, vals, b, 37, 53, 0, 0, 1.0)
    got = np.asarray(fn(jnp.asarray(rows), jnp.asarray(cols),
                        jnp.asarray(vals), jnp.asarray(b), 37, 53))
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-6)


@pytest.mark.parametrize("fn", [coo_apply.coo_left_apply,
                                coo_apply.coo_left_apply_dense,
                                coo_apply.coo_left_apply_panels])
def test_variants_match_oracle_window_alpha(fn):
    # submatrix window with offsets + alpha, entries falling outside the
    # window masked (set_filtered_coo analog, coo_spmm_impl.hh:46-75)
    rows, cols, vals, b_full = _mk(500, 41, 67, 9, seed=2)
    d, m, ro, co, alpha = 13, 29, 5, 11, -0.75
    b = b_full[:m]
    want = _oracle(rows, cols, vals, b, d, m, ro, co, alpha)
    got = np.asarray(fn(jnp.asarray(rows), jnp.asarray(cols),
                        jnp.asarray(vals), jnp.asarray(b), d, m,
                        ro, co, alpha))
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-6)


def test_panels_multiple_and_ragged():
    # more than one panel, last panel ragged (panel doesn't divide m)
    rows, cols, vals, b = _mk(800, 24, 100, 8, seed=3)
    want = _oracle(rows, cols, vals, b, 24, 100, 0, 0, 1.0)
    got = np.asarray(coo_apply.coo_left_apply_panels(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
        jnp.asarray(b), 24, 100, panel=32))
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-6)


def test_auto_dispatch_routes(monkeypatch):
    calls = []
    real_dense = coo_apply.coo_left_apply_dense
    real_panels = coo_apply.coo_left_apply_panels
    real_seg = coo_apply.coo_left_apply
    monkeypatch.setattr(coo_apply, "coo_left_apply_dense",
                        lambda *a, **k: calls.append("dense")
                        or real_dense(*a, **k))
    monkeypatch.setattr(coo_apply, "coo_left_apply_panels",
                        lambda *a, **k: calls.append("panels")
                        or real_panels(*a, **k))
    monkeypatch.setattr(coo_apply, "coo_left_apply",
                        lambda *a, **k: calls.append("segsum")
                        or real_seg(*a, **k))

    rows, cols, vals, b = _mk(256, 32, 48, 4, seed=4)
    r, c, v, bb = map(jnp.asarray, (rows, cols, vals, b))
    # skinny b, tiny nnz*n -> segment-sum
    coo_apply.coo_left_apply_auto(r, c, v, bb, 32, 48)
    assert calls[-1] == "segsum"
    # wide b crosses the densify threshold (nnz*n > 4*d*m); within
    # budget -> one-shot dense densify
    wide = jnp.zeros((48, 64), jnp.float32)
    monkeypatch.setattr(coo_apply, "_DENSE_BUDGET", 32 * 48)
    coo_apply.coo_left_apply_auto(r, c, v, wide, 32, 48)
    assert calls[-1] == "dense"
    # same but operator over budget -> panels fallback
    monkeypatch.setattr(coo_apply, "_DENSE_BUDGET", 32 * 48 - 1)
    coo_apply.coo_left_apply_auto(r, c, v, wide, 32, 48)
    assert calls[-1] == "panels"


def test_dense_variant_grad():
    # sparse values gradient flows through the flat scatter-add
    rows, cols, vals, b = _mk(200, 16, 24, 6, seed=6)
    r, c = jnp.asarray(rows), jnp.asarray(cols)
    bb = jnp.asarray(b)

    def loss(v):
        return jnp.sum(coo_apply.coo_left_apply_dense(
            r, c, v, bb, 16, 24) ** 2)

    g = jax.grad(loss)(jnp.asarray(vals))
    # finite-difference spot check
    i = 7
    eps = 1e-3
    vp = vals.copy(); vp[i] += eps
    vm = vals.copy(); vm[i] -= eps
    fd = (loss(jnp.asarray(vp)) - loss(jnp.asarray(vm))) / (2 * eps)
    np.testing.assert_allclose(g[i], fd, rtol=2e-2, atol=1e-3)
