"""Regression tests for the round-1 advisor findings (ADVICE.md) and
VERDICT.md weak item #4 (silently-dropped beta).

Each test pins a bug that previously produced a wrong answer silently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from randblas_tpu import (
    DenseDist, DenseSkOp, RNGState, SparseDist, SparseSkOp, sketch_general,
)
from randblas_tpu.ops.accumulate import accumulate
from randblas_tpu.parallel import distributed_sketch, make_sketch_mesh
from randblas_tpu.parallel.distributed import distributed_sketch_right
from randblas_tpu.util import sample_indices_iid, sample_indices_iid_uniform
from randblas_tpu.util import weights_to_cdf


# -- ADVICE high (round 2): misaligned per-shard width used to be a
# silent-wrongness hazard, so it raised. Round 3's pad-and-shard scheme
# removed the hazard altogether: shard extents round UP to counter
# alignment and the formerly-rejected shapes now compute the exact
# single-device result. These tests pin the new contract.

@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
def test_distributed_sketch_misaligned_shard_pads():
    # m = 20 over data=2 -> m_per rounds 10 -> 12; previously ValueError
    # (and before that, a silently-wrong sketch with max err ~12).
    S = DenseSkOp(DenseDist(8, 20), RNGState.from_key(0))
    A = jnp.asarray(
        np.random.default_rng(7).normal(size=(20, 4)).astype(np.float32))
    mesh = make_sketch_mesh(2, 2, jax.devices()[:4])
    got = np.asarray(distributed_sketch(S, A, mesh))
    want = np.asarray(S.materialize()) @ np.asarray(A)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
def test_distributed_sketch_right_misaligned_shard_pads():
    # tall (m=20, d=8) operator, m sharded over data=2 -> m_per 10 -> 12
    S = DenseSkOp(DenseDist(20, 8), RNGState.from_key(0))
    A = jnp.asarray(
        np.random.default_rng(8).normal(size=(4, 20)).astype(np.float32))
    mesh = make_sketch_mesh(2, 2, jax.devices()[:4])
    got = np.asarray(distributed_sketch_right(S, A, mesh))
    want = np.asarray(A) @ np.asarray(S.materialize())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
def test_distributed_sketch_single_data_shard_offset_free():
    # pd == 1 means the lane offset is always 0: any m is fine.
    S = DenseSkOp(DenseDist(8, 18), RNGState.from_key(3))
    A = jnp.asarray(
        np.random.default_rng(1).normal(size=(18, 4)).astype(np.float32))
    mesh = make_sketch_mesh(4, 1, jax.devices()[:4])
    got = np.asarray(distributed_sketch(S, A, mesh))
    want = np.asarray(S.materialize()) @ np.asarray(A)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- ADVICE medium: user-supplied COO triplets in arbitrary order -----------

@pytest.mark.parametrize("d,m", [(8, 64), (64, 8)])
def test_user_supplied_shuffled_triplets_correct(d, m):
    dist = SparseDist(d, m, vec_nnz=3)
    S = SparseSkOp(dist, RNGState.from_key(7)).filled()
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(np.asarray(S.rows)))
    S_shuf = SparseSkOp(dist, RNGState.from_key(7),
                        rows=jnp.asarray(np.asarray(S.rows)[perm]),
                        cols=jnp.asarray(np.asarray(S.cols)[perm]),
                        vals=jnp.asarray(np.asarray(S.vals)[perm]))
    assert not S_shuf.canonical and S.canonical
    A = jnp.asarray(rng.normal(size=(m, 5)).astype(np.float32))
    got = np.asarray(sketch_general(S_shuf, A))
    want = np.asarray(S_shuf.materialize()) @ np.asarray(A)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # same values as the canonical operator (it is the same matrix)
    np.testing.assert_allclose(got, np.asarray(sketch_general(S, A)),
                               rtol=1e-5, atol=1e-5)


def test_transpose_preserves_canonical_fast_path():
    S = SparseSkOp(SparseDist(8, 64, vec_nnz=4), RNGState.from_key(2))
    St = S.transpose()
    assert St.filled().canonical
    A = jnp.asarray(
        np.random.default_rng(3).normal(size=(8, 5)).astype(np.float32))
    got = np.asarray(sketch_general(St, A))
    want = np.asarray(St.materialize()) @ np.asarray(A)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- ADVICE medium: traced beta == 0 must overwrite, not multiply -----------

def test_traced_beta_zero_overwrites_nonfinite_out():
    prod = jnp.ones((2, 2), jnp.float32)
    out = jnp.asarray([[np.nan, np.inf], [1.0, -np.inf]], jnp.float32)

    res = jax.jit(accumulate)(prod, jnp.float32(0.0), out)
    np.testing.assert_array_equal(np.asarray(res), np.ones((2, 2)))

    res2 = jax.jit(accumulate)(prod, jnp.float32(2.0),
                               jnp.full((2, 2), 3.0, jnp.float32))
    np.testing.assert_allclose(np.asarray(res2), 7.0)


# -- VERDICT weak 4 / ADVICE low: beta without out must error ---------------

def test_beta_without_out_raises():
    S = DenseSkOp(DenseDist(4, 8), RNGState.from_key(0))
    A = jnp.ones((8, 3), jnp.float32)
    with pytest.raises(ValueError, match="beta"):
        sketch_general(S, A, beta=1.0)
    # beta with out works; beta=0 without out works
    out = jnp.ones((4, 3), jnp.float32)
    sketch_general(S, A, beta=1.0, out=out)
    sketch_general(S, A, beta=0.0)


def test_beta_without_out_raises_sketch_sparse():
    from randblas_tpu.sparse_data import COOMatrix
    from randblas_tpu import sketch_sparse
    S = DenseSkOp(DenseDist(4, 8), RNGState.from_key(0))
    A = COOMatrix.from_dense(jnp.eye(8, 6, dtype=jnp.float32))
    with pytest.raises(ValueError, match="beta"):
        sketch_sparse(S, A, beta=1.0)


# -- ADVICE low: index sampling in double precision --------------------------

def test_sample_indices_iid_uniform_matches_f64_for_large_n():
    # n > 2^24: f32 rounding of u01 visibly quantizes indices; the host
    # path must reproduce the reference's double computation.
    n = 1 << 28
    k = 512
    state = RNGState.from_key(11)
    samples, _ = sample_indices_iid_uniform(n, k, state)
    samples = np.asarray(samples)

    # oracle: raw bits -> uneg11 in f64 -> floor(n * u01)
    from randblas_tpu.util import _uneg11_f64, _uniform_stream_bits
    bits, _ = _uniform_stream_bits(state, k)
    u01 = (_uneg11_f64(np.asarray(bits)) + 1.0) / 2.0
    want = np.clip(np.floor(n * u01).astype(np.int64), 0, n - 1)
    np.testing.assert_array_equal(samples.astype(np.int64), want)
    # and f32 would NOT have matched (sanity that the test has teeth)
    u32 = (np.asarray(bits).view(np.int32).astype(np.float32)
           * np.float32(2 ** -31) + np.float32(2 ** -32))
    f32_idx = np.floor(np.float32(n) * ((u32 + 1) / 2)).astype(np.int64)
    assert (f32_idx != want).any()


def test_sample_indices_iid_f64_cdf_path():
    w = np.linspace(1, 3, 1000)
    cdf = weights_to_cdf(jnp.asarray(w, jnp.float64))
    samples, nxt = sample_indices_iid(cdf, 64, RNGState.from_key(4))
    samples = np.asarray(samples)
    assert samples.min() >= 0 and samples.max() < 1000
    assert nxt.counter_as_int() == -(-64 // 4)


# -- round-3 code-review findings ---------------------------------------------

def test_distributed_alpha_keeps_f64_precision():
    """alpha must reach the shard body in the compute dtype: an f32
    round-trip of 0.1 costs ~1.5e-8 relative error on every f64 output
    element (code-review finding, round 3)."""
    import jax
    was_x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        from randblas_tpu import DenseDist, DenseSkOp, RNGState
        mesh = make_sketch_mesh(2, 4)
        S = DenseSkOp(DenseDist(8, 32), RNGState.from_key(3),
                      dtype=jnp.float64)
        A = jnp.asarray(np.random.default_rng(0).normal(size=(32, 6)),
                        jnp.float64)
        got = np.asarray(distributed_sketch(S, A, mesh, alpha=0.1))
        want = 0.1 * np.asarray(S.materialize(), np.float64) @ np.asarray(A)
        # rtol far below f32(0.1)'s 1.5e-8 representation error
        np.testing.assert_allclose(got, want, rtol=1e-13)
    finally:
        jax.config.update("jax_enable_x64", was_x64)


def test_hutchpp_matvec_budget():
    """hutchpp must spend exactly its documented matvec budget: k (sketch)
    + k (trace of the projected block) + k (residual) applications."""
    from randblas_tpu.linalg import hutchpp
    from randblas_tpu import RNGState
    n, budget = 32, 12
    a = jnp.asarray(np.random.default_rng(1).normal(size=(n, n)),
                    jnp.float32)
    a = a @ a.T
    calls = []

    def mv(x):
        calls.append(x.shape[1])
        return a @ x

    est, _ = hutchpp(mv, n, budget, RNGState.from_key(2))
    assert sum(calls) == 3 * (budget // 3), calls
    np.testing.assert_allclose(float(est), float(jnp.trace(a)),
                               rtol=0.5)


def test_leverage_rejects_jl_dim_ge_n():
    from randblas_tpu.linalg import leverage_scores
    from randblas_tpu import RNGState
    a = jnp.asarray(np.random.default_rng(0).normal(size=(60, 8)),
                    jnp.float32)
    with pytest.raises(ValueError, match="jl_dim"):
        leverage_scores(a, RNGState.from_key(1), jl_dim=8)


def test_coo_flat_scatter_limit_fallback():
    """The 2-D scatter fallback (flat int32 index would overflow) must
    produce the same product as the linearized path."""
    from randblas_tpu.ops import coo_apply as ca
    rng = np.random.default_rng(5)
    d, m, nnz, n = 40, 50, 300, 7
    rows = jnp.asarray(rng.integers(0, d, nnz), jnp.int32)
    cols = jnp.asarray(rng.integers(0, m, nnz), jnp.int32)
    vals = jnp.asarray(rng.normal(size=nnz), jnp.float32)
    b = jnp.asarray(rng.normal(size=(m, n)), jnp.float32)
    want_dense = ca.coo_left_apply_dense(rows, cols, vals, b, d, m)
    want_panel = ca.coo_left_apply_panels(rows, cols, vals, b, d, m,
                                          panel=16)
    old = ca._FLAT_SCATTER_LIMIT
    ca._FLAT_SCATTER_LIMIT = 1   # force the 2-D branch everywhere
    try:
        got_dense = ca.coo_left_apply_dense(rows, cols, vals, b, d, m)
        got_panel = ca.coo_left_apply_panels(rows, cols, vals, b, d, m,
                                             panel=16)
    finally:
        ca._FLAT_SCATTER_LIMIT = old
    np.testing.assert_allclose(np.asarray(got_dense), np.asarray(want_dense),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got_panel), np.asarray(want_panel),
                               rtol=1e-6, atol=1e-6)


# -- round-3 advisor findings (ADVICE.md r3) ---------------------------------

@pytest.mark.slow
def test_arnoldi_coerces_matvec_dtype():
    """An f64 A with an f32 b (under x64) used to raise an obscure
    dynamic_update_slice dtype mismatch inside the Arnoldi loop; the
    body must cast matvec output to the basis dtype — for dense, sparse
    AND callable operators (sgmres and sketched_eigs share the loop)."""
    import jax
    was_x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        from randblas_tpu.linalg import sgmres, sketched_eigs
        from randblas_tpu.sparse_data import COOMatrix
        rng = np.random.default_rng(2)
        n = 24
        # diagonally-dominant shift so the full-basis solve genuinely
        # converges in f32 (the test's subject is dtype coercion, but a
        # near-singular A would make the residual bar meaningless)
        a64 = jnp.asarray(rng.normal(size=(n, n)) + 8 * np.eye(n),
                          jnp.float64)
        b32 = jnp.asarray(rng.normal(size=n), jnp.float32)
        x, res, _ = sgmres(a64, b32, RNGState.from_key(1), basis=n)
        assert x.dtype == jnp.float32
        true_res = np.linalg.norm(np.asarray(a64) @ np.asarray(x, np.float64)
                                  - np.asarray(b32, np.float64))
        assert true_res / np.linalg.norm(np.asarray(b32)) < 1e-3
        # callable and sparse paths through sketched_eigs
        sp64 = COOMatrix.from_dense(a64 + a64.T)
        theta, _, _, _ = sketched_eigs(sp64, 2, RNGState.from_key(2),
                                       sym=True, dtype=jnp.float32)
        assert np.isfinite(np.asarray(theta)).all()
        mv64 = lambda v: (a64 + a64.T) @ v.astype(jnp.float64)
        theta2, _, _, _ = sketched_eigs(mv64, 2, RNGState.from_key(2),
                                        sym=True, n=n, dtype=jnp.float32)
        np.testing.assert_allclose(np.asarray(theta2), np.asarray(theta),
                                   rtol=1e-3)
    finally:
        jax.config.update("jax_enable_x64", was_x64)


@pytest.mark.slow
def test_sgmres_warns_on_zero_oversampling():
    """d == m < n voids the ~sqrt(m/d) distortion contract — warn."""
    from randblas_tpu.linalg import sgmres, sketched_eigs
    rng = np.random.default_rng(3)
    n = 32
    a = jnp.asarray(rng.normal(size=(n, n)) + 4 * np.eye(n), jnp.float32)
    b = jnp.asarray(rng.normal(size=n), jnp.float32)
    with pytest.warns(UserWarning, match="oversampling"):
        sgmres(a, b, RNGState.from_key(0), basis=8, d=8)
    with pytest.warns(UserWarning, match="oversampling"):
        sketched_eigs(a, 2, RNGState.from_key(0), basis=8, d=8)
    # the default d = 2m + 8 must stay silent, as must d == m == n
    # (a square embedding is a mere change of basis)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sgmres(a, b, RNGState.from_key(0), basis=8)
        sgmres(a, b, RNGState.from_key(0), basis=n, d=n)


def test_arnoldi_happy_breakdown_zeroes_columns():
    """EXACT invariance (A = I: the Krylov space is 1-dimensional) must
    produce exactly-zero basis columns past the breakdown point, per the
    documented contract."""
    from randblas_tpu.linalg.sgmres import _truncated_arnoldi
    n, m = 16, 5
    b = jnp.asarray(np.random.default_rng(4).normal(size=n), jnp.float32)
    q, aq = _truncated_arnoldi(lambda v: v, b, m, 3)
    q_np = np.asarray(q)
    np.testing.assert_allclose(q_np[:, 0], np.asarray(b / jnp.linalg.norm(b)),
                               rtol=1e-6)
    np.testing.assert_array_equal(q_np[:, 1:], 0.0)
    # AQ column 0 recorded before the breakdown is exact
    np.testing.assert_allclose(np.asarray(aq)[:, 0], q_np[:, 0], rtol=1e-6)


def test_pallas_fill_interp_flag_is_live():
    """The staged operator block is the XLA fill, whatever dispatch
    flags are in scope: uniform streams are exact float arithmetic, so
    the block is bit-identical to fill_dense_submat."""
    import randblas_tpu as rb
    from randblas_tpu.dense import fill_dense_submat
    from randblas_tpu.skge import _dense_block
    from randblas_tpu.base import Op
    S = rb.DenseSkOp(rb.DenseDist(16, 64, family=rb.DenseDistName.Uniform),
                     rb.RNGState.from_key(9))
    base = fill_dense_submat(S.dist, S.seed_state, 16, 64, 0, 0)
    for use_fused in ("auto", True, False):
        with rb.flags(use_fused=use_fused):
            blk = _dense_block(S, 16, 64, 0, 0, Op.NoTrans, jnp.float32)
        np.testing.assert_array_equal(np.asarray(blk), np.asarray(base))


# -- ADVICE round 4 (all four findings) --------------------------------------

def test_kpm_density_sparse_gershgorin():
    """ADVICE r4: kpm_density(bounds=None) with a sparse container used
    to reach the dense Gershgorin branch (sparse containers expose
    .shape) and crash in jnp.diagonal. Now it computes a sparse-aware
    Gershgorin enclosure and runs."""
    from randblas_tpu.linalg import kpm_density
    from randblas_tpu.sparse_data.coo import COOMatrix
    from randblas_tpu.sparse_data.conversions import coo_to_csr

    rng = np.random.default_rng(0)
    n = 48
    m = rng.normal(size=(n, n)).astype(np.float32)
    a_np = (m + m.T) / 2
    a_np[np.abs(a_np) < 0.8] = 0.0       # sparsify, keep symmetry
    a = COOMatrix.from_dense(jnp.asarray(a_np))

    grid, dens, _ = kpm_density(a, RNGState.from_key(3), degree=64,
                                probes=8, npts=201)
    total = np.trapezoid(np.asarray(dens), np.asarray(grid))
    assert abs(total - n) / n < 0.15     # counting normalization holds
    assert np.all(np.isfinite(np.asarray(dens)))

    # the enclosure must match the dense Gershgorin bound: same grid
    grid_d, _, _ = kpm_density(jnp.asarray(a_np), RNGState.from_key(3),
                               degree=64, probes=8, npts=201)
    np.testing.assert_allclose(np.asarray(grid), np.asarray(grid_d),
                               rtol=1e-6)

    # CSR route works too (exercises to_coo normalization)
    kpm_density(coo_to_csr(a), RNGState.from_key(3), degree=16, probes=2,
                npts=31)


def test_kpm_density_callable_still_requires_bounds():
    from randblas_tpu.linalg import kpm_density
    with pytest.raises(ValueError, match="bounds"):
        kpm_density(lambda x: x, RNGState.from_key(0), n=8)


def test_sgmres_default_d_clamped_no_warning():
    """ADVICE r4: with all-default parameters and n < basis+4, the thin-
    embedding warning used to fire with an unreachable remedy. The
    defaulted-and-clamped case must be silent; an explicit thin d still
    warns, with a reachable remedy."""
    import warnings
    from randblas_tpu.linalg import sgmres

    rng = np.random.default_rng(1)
    n = 12
    a = jnp.asarray((rng.normal(size=(n, n)) + 4 * np.eye(n)
                     ).astype(np.float32))
    b = jnp.asarray(rng.normal(size=n).astype(np.float32))

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        x, res, _ = sgmres(a, b, RNGState.from_key(0), basis=n - 2)

    with pytest.warns(UserWarning, match="Reduce the basis"):
        sgmres(a, b, RNGState.from_key(0), basis=n - 2, d=n - 2)


def test_xtrace_stderr_uses_sample_std():
    """ADVICE r4: xtrace's a-posteriori stderr uses the unbiased (ddof=1)
    sample standard deviation."""
    from randblas_tpu.linalg import xtrace
    n = 64
    a_np = np.diag(np.linspace(1.0, 2.0, n)).astype(np.float32)
    est, stderr, _ = xtrace(jnp.asarray(a_np), n, 8, RNGState.from_key(5))
    assert np.isfinite(float(stderr)) and float(stderr) >= 0.0
    # minimal budget (m = 2 leave-one-out estimates): ddof=1 stays finite
    est2, stderr2, _ = xtrace(jnp.asarray(a_np), n, 4, RNGState.from_key(5))
    assert np.isfinite(float(stderr2))
