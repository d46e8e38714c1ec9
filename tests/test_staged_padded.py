"""Row-aligned fill generation + the TN high-precision GEMM.

fill_rowmajor generates a row count rounded up to a multiple of 8 and
slices the phantom rows off. These tests pin that the padding is value-invisible,
and that matmul_hiprec's transpose_a path (TN contraction for natural-
orientation operands) is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import randblas_tpu as rb
from randblas_tpu.ops.dense_fill import fill_rowmajor
from randblas_tpu.ops.f64gemm import matmul_hiprec

RNG = np.random.default_rng(7)


@pytest.mark.parametrize("parent,rows,cols,ptr", [
    (37, 9, 30, 2 * 37 + 5),   # rows % 8 = 1, unaligned ptr
    (4002, 11, 4002, 0),       # config-1-like width
    (40, 8, 40, 0),            # already aligned (padding is a no-op)
])
def test_row_padding_is_value_invisible(parent, rows, cols, ptr):
    st = rb.RNGState.from_key(3)
    got = fill_rowmajor(parent, rows, cols, ptr, st, "boxmul")
    # a bigger fill's row prefix must equal the smaller fill exactly:
    # phantom rows may only ever EXTEND the counter walk, never shift it
    bigger = fill_rowmajor(parent, rows + 5, cols, ptr, st, "boxmul")
    assert got.shape == (rows, cols)
    np.testing.assert_array_equal(np.asarray(bigger[:rows]),
                                  np.asarray(got))


@pytest.mark.parametrize("m,k,n,kb", [(33, 70, 17, None),
                                      (64, 300, 32, 128)])
def test_matmul_hiprec_transpose_a(m, k, n, kb):
    a = jnp.asarray(RNG.normal(size=(k, m)))   # stored (k, m)
    b = jnp.asarray(RNG.normal(size=(k, n)))
    ref = matmul_hiprec(a.T, b, k_block=kb)
    got = matmul_hiprec(a, b, transpose_a=True, k_block=kb)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-15, atol=0)


def test_matmul_hiprec_transpose_a_f32_slices():
    a = jnp.asarray(RNG.normal(size=(100, 40)).astype(np.float32))
    b = jnp.asarray(RNG.normal(size=(100, 8)))
    ref = np.asarray(a, np.float64).T @ np.asarray(b)
    got = matmul_hiprec(a, b, transpose_a=True, slices_a=8)
    rel = np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()
    assert rel < 1e-14, rel


def test_matmul_hiprec_transpose_a_bad_shapes():
    a = jnp.zeros((4, 5))
    b = jnp.zeros((4, 3))
    with pytest.raises(ValueError):
        matmul_hiprec(a.T, b, transpose_a=True)  # (5,4) x (4,3) w/ ta
