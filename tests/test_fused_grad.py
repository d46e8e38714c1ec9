"""Autodiff through the RNG-in-GEMM kernel (jax.custom_vjp), in the
Pallas interpreter.

The sketch is linear in A, so its cotangent is the transposed sketch
block^T @ g — computed by the same kernel in the other counter
orientation with the same seed, regenerating the operator from counters.
Nothing is stored for the backward pass except the seed. First-order
reverse-mode only (custom_vjp); forward-mode / higher-order users should
scope flags(use_fused=False).

The reference has no autodiff surface; this is JAX-native.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import randblas_tpu as rb
from randblas_tpu.ops import fused_sketch as fs

RNG = np.random.default_rng(0)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.mark.slow
def test_rowmajor_grad_vs_staged():
    S = rb.DenseSkOp(rb.DenseDist(16, 64), rb.RNGState.from_key(1))
    A = jnp.asarray(RNG.normal(size=(64, 24)).astype(np.float32))
    g = jax.grad(lambda a: jnp.sum(
        fs.fused_sketch(S, a, alpha=0.5, interpret=True) ** 2))(A)
    g_ref = jax.grad(lambda a: jnp.sum(
        (0.5 * (S.materialize() @ a)) ** 2))(A)
    assert _rel(g, g_ref) < 1e-2


@pytest.mark.slow
def test_colmajor_grad_vs_staged():
    S = rb.DenseSkOp(rb.DenseDist(96, 32), rb.RNGState.from_key(2))
    A = jnp.asarray(RNG.normal(size=(32, 16)).astype(np.float32))
    g = jax.grad(lambda a: jnp.sum(
        fs.fused_sketch(S, a, interpret=True) ** 2))(A)
    g_ref = jax.grad(lambda a: jnp.sum((S.materialize() @ a) ** 2))(A)
    assert _rel(g, g_ref) < 1e-2


@pytest.mark.slow
def test_submatrix_unaligned_grad():
    big = rb.DenseSkOp(rb.DenseDist(40, 120), rb.RNGState.from_key(3))
    A = jnp.asarray(RNG.normal(size=(64, 8)).astype(np.float32))
    g = jax.grad(lambda a: jnp.sum(fs.fused_sketch(
        big, a, interpret=True, rows_s=24, cols_s=64, ro_s=8,
        co_s=13) ** 2))(A)
    blk = jnp.asarray(np.asarray(big.materialize())[8:32, 13:77])
    g_ref = jax.grad(lambda a: jnp.sum((blk @ a) ** 2))(A)
    assert _rel(g, g_ref) < 1e-2


def test_uniform_family_grad():
    S = rb.DenseSkOp(rb.DenseDist(16, 64, rb.DenseDistName.Uniform),
                     rb.RNGState.from_key(4))
    A = jnp.asarray(RNG.normal(size=(64, 8)).astype(np.float32))
    g = jax.grad(lambda a: jnp.sum(
        fs.fused_sketch(S, a, interpret=True) ** 2))(A)
    g_ref = jax.grad(lambda a: jnp.sum((S.materialize() @ a) ** 2))(A)
    assert _rel(g, g_ref) < 1e-2


def test_grad_through_sketch_general_forced_fused():
    """The public dispatch path stays differentiable when fused is
    forced (interpret-mode kernels via the forced-fuzz machinery)."""
    from randblas_tpu.ops import fused_sketch
    S = rb.DenseSkOp(rb.DenseDist(16, 64), rb.RNGState.from_key(5))
    A = jnp.asarray(RNG.normal(size=(64, 8)).astype(np.float32))
    # direct fused call == what forced dispatch runs; value parity first
    out = fused_sketch.fused_sketch(S, A, interpret=True)
    want = rb.sketch(S, A)
    assert _rel(out, want) < 1e-2
    g = jax.grad(lambda a: jnp.sum(
        fused_sketch.fused_sketch(S, a, interpret=True)))(A)
    g_ref = jax.grad(lambda a: jnp.sum(S.materialize() @ a))(A)
    assert _rel(g, g_ref) < 1e-2


def test_value_and_grad_jit():
    S = rb.DenseSkOp(rb.DenseDist(16, 64), rb.RNGState.from_key(6))
    A = jnp.asarray(RNG.normal(size=(64, 8)).astype(np.float32))
    f = jax.jit(jax.value_and_grad(lambda a: jnp.sum(
        fs.fused_sketch(S, a, interpret=True) ** 2)))
    v, g = f(A)
    v_ref = float(jnp.sum((S.materialize() @ A) ** 2))
    assert abs(float(v) - v_ref) / v_ref < 1e-2
    assert g.shape == A.shape


def test_bf16_grad_dtype():
    S = rb.DenseSkOp(rb.DenseDist(16, 64), rb.RNGState.from_key(7))
    A = jnp.asarray(RNG.normal(size=(64, 8)).astype(np.float32)).astype(
        jnp.bfloat16)
    g = jax.grad(lambda a: jnp.sum(
        fs.fused_sketch(S, a, interpret=True).astype(jnp.float32)))(A)
    assert g.dtype == jnp.bfloat16


def test_forward_values_unchanged():
    """The custom_vjp wrapper must not perturb primal values (bitwise
    vs the kernel call without it)."""
    S = rb.DenseSkOp(rb.DenseDist(16, 64), rb.RNGState.from_key(8))
    A = jnp.asarray(RNG.normal(size=(64, 8)).astype(np.float32))
    out = fs.fused_sketch(S, A, interpret=True)
    st = S.seed_state
    direct = fs._call(fs.seed_words(st.counter, st.key), A, d=16,
                      gaussian=True, ctr_stride=16, stride_axis=0,
                      rng=st.rng, interpret=True)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(direct))


def test_sparse_operator_grad():
    """SASO sketching is pure XLA (one-hot panels / gathers) and
    differentiates exactly."""
    S = rb.SparseSkOp(rb.SparseDist(16, 64, vec_nnz=4),
                      rb.RNGState.from_key(9))
    A = jnp.asarray(RNG.normal(size=(64, 8)).astype(np.float32))
    g = jax.grad(lambda a: jnp.sum(rb.sketch(S, a) ** 2))(A)
    g_ref = jax.grad(lambda a: jnp.sum((S.materialize() @ a) ** 2))(A)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               rtol=1e-5, atol=1e-5)


def test_coo_spmm_grad():
    """COO SpMM differentiates exactly (the differentiable sparse-data
    route)."""
    from randblas_tpu.sparse_data import COOMatrix
    rng = np.random.default_rng(1)
    dense = ((rng.random((20, 40)) < 0.2)
             * rng.normal(size=(20, 40))).astype(np.float32)
    coo = COOMatrix.from_dense(jnp.asarray(dense))
    B = jnp.asarray(rng.normal(size=(40, 4)).astype(np.float32))
    g = jax.grad(lambda b: jnp.sum(rb.left_spmm(coo, b) ** 2))(B)
    g_ref = jax.grad(lambda b: jnp.sum((jnp.asarray(dense) @ b) ** 2))(B)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_square_dist_grad():
    """A square dist transposes to itself (the layout does not flip), yet
    the cotangent must still be block^T @ g: the backward pass flips the
    kernel's counter orientation, not the distribution. square+Long is
    ColMajor-natural, square+Short RowMajor-natural."""
    from randblas_tpu.base import MajorAxis
    fn = fs.fused_sketch
    A = jnp.asarray(RNG.normal(size=(32, 8)).astype(np.float32))
    for ma in (MajorAxis.Long, MajorAxis.Short):
        S = rb.DenseSkOp(rb.DenseDist(32, 32, major_axis=ma),
                         rb.RNGState.from_key(12))
        out = fn(S, A, interpret=True)
        want = S.materialize() @ A
        assert _rel(out, want) < 1e-2, (ma, "forward")
        g = jax.grad(lambda a: jnp.sum(fn(S, a, interpret=True) ** 2))(A)
        g_ref = jax.grad(lambda a: jnp.sum((S.materialize() @ a) ** 2))(A)
        assert _rel(g, g_ref) < 1e-2, ma
