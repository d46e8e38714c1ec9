"""f64 tier: the integer-sliced high-precision GEMM and its use by
sketch_general (the reference is templated over T in {float, double};
skge.hh:174-364 — BASELINE config 1 is fp64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from randblas_tpu import DenseDist, DenseSkOp, RNGState, sketch_general
from randblas_tpu.ops.f64gemm import matmul_hiprec

RNG = np.random.default_rng(42)


@pytest.mark.parametrize("m,k,n", [(64, 128, 32), (100, 1000, 50),
                                   (7, 33, 5)])
def test_matmul_hiprec_f64_accuracy(m, k, n):
    a = RNG.normal(size=(m, k))
    b = RNG.normal(size=(k, n))
    c = np.asarray(matmul_hiprec(jnp.asarray(a), jnp.asarray(b)))
    c0 = a @ b
    assert c.dtype == np.float64
    rel = np.abs(c - c0).max() / np.abs(c0).max()
    assert rel < 1e-14, rel


def test_matmul_hiprec_ill_scaled_componentwise():
    # row/column scales spanning ~2^57: the per-row/col power-of-two
    # scaling must keep the error componentwise, not global
    a = RNG.normal(size=(50, 200)) * np.exp(RNG.normal(size=(50, 1)) * 20)
    b = RNG.normal(size=(200, 30)) * np.exp(RNG.normal(size=(1, 30)) * 20)
    c = np.asarray(matmul_hiprec(jnp.asarray(a), jnp.asarray(b)))
    bound = np.abs(a) @ np.abs(b)
    assert (np.abs(c - a @ b) / bound).max() < 1e-14


def test_matmul_hiprec_zero_rows_cols():
    a = RNG.normal(size=(8, 16))
    a[3] = 0.0
    b = RNG.normal(size=(16, 4))
    b[:, 2] = 0.0
    c = np.asarray(matmul_hiprec(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(c, a @ b, rtol=1e-14, atol=0)
    assert (c[3] == 0).all() and (c[:, 2] == 0).all()


def test_matmul_hiprec_jits():
    a = jnp.asarray(RNG.normal(size=(32, 64)))
    b = jnp.asarray(RNG.normal(size=(64, 16)))
    f = jax.jit(matmul_hiprec)
    want = np.asarray(a) @ np.asarray(b)
    np.testing.assert_allclose(np.asarray(f(a, b)), want, rtol=1e-13,
                               atol=1e-13 * np.abs(want).max())


def test_sketch_general_f64_matches_f64_oracle():
    # the f64 sketching path: operator values are f32-exact promoted to
    # f64 (like the reference's copy_promote, dense_skops.hh:50-55), data
    # is genuine f64; the product must be f64-accurate.
    d, m, n = 8, 200, 6
    S = DenseSkOp(DenseDist(d, m), RNGState.from_key(5), dtype=jnp.float64)
    A = RNG.normal(size=(m, n))
    got = np.asarray(sketch_general(S, jnp.asarray(A)))
    assert got.dtype == np.float64
    want = np.asarray(S.materialize()).astype(np.float64) @ A
    np.testing.assert_allclose(got, want, rtol=1e-13)


def test_sketch_general_f64_forced_hiprec():
    # force the sliced path ("auto" uses the native f64 matmul)
    from randblas_tpu import skge
    d, m, n = 8, 100, 6
    S = DenseSkOp(DenseDist(d, m), RNGState.from_key(6), dtype=jnp.float64)
    A = RNG.normal(size=(m, n))
    old = skge.use_hiprec_f64
    try:
        skge.use_hiprec_f64 = True
        got = np.asarray(sketch_general(S, jnp.asarray(A)))
    finally:
        skge.use_hiprec_f64 = old
    want = np.asarray(S.materialize()).astype(np.float64) @ A
    np.testing.assert_allclose(got, want, rtol=1e-13)


@pytest.mark.slow
def test_matmul_hiprec_blocked_k():
    # k above the block size: blocked accumulation must be exact and
    # identical for any block size (shared full-axis grid)
    a = RNG.normal(size=(24, 40_000))
    b = RNG.normal(size=(40_000, 6))
    c0 = a @ b
    for kb in (16384, 7777):
        c = np.asarray(matmul_hiprec(jnp.asarray(a), jnp.asarray(b),
                                     k_block=kb))
        rel = np.abs(c - c0).max() / np.abs(c0).max()
        assert rel < 1e-14, (kb, rel)


def test_submat_dtype_override_bitwise_vs_materialized():
    """A narrowed submat view equals materialize()-then-cast BITWISE for
    both families (code-review finding, round 3: Uniform's sqrt(3) scale
    applied in the narrow dtype double-rounded ~1 ulp apart)."""
    import randblas_tpu as rb
    from randblas_tpu import DenseDist, DenseDistName, DenseSkOp, RNGState
    for family in (DenseDistName.Gaussian, DenseDistName.Uniform):
        S = DenseSkOp(DenseDist(8, 8, family), RNGState.from_key(1),
                      dtype=jnp.float64)
        lazy = np.asarray(S.submat(8, 8, 0, 0, dtype=jnp.float32))
        S2 = DenseSkOp(DenseDist(8, 8, family), RNGState.from_key(1),
                       dtype=jnp.float64)
        S2.materialize()
        mat = np.asarray(S2.submat(8, 8, 0, 0, dtype=jnp.float32))
        np.testing.assert_array_equal(lazy, mat)


@pytest.mark.slow
def test_blocked_path_unaligned_tail():
    """k > k_block with an unaligned tail: the tail block is padded in
    isolation (the full operands are never k-padded) and the result
    stays exact."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(32, 300))
    b = rng.normal(size=(300, 16))
    got = np.asarray(matmul_hiprec(jnp.asarray(a), jnp.asarray(b),
                                   k_block=128))
    want = a @ b
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-14
