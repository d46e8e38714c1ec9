"""BlockedELL format + its plain-XLA SpMM (compare-select densify + GEMM)."""

import jax.numpy as jnp
import numpy as np
import pytest

from randblas_tpu.sparse_data import (
    BlockedELL, ELLMatrix, blocked_ell_matmul,
)

RNG = np.random.default_rng(11)


def _ell(m, k, density=0.05, seed=0):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(m, k)).astype(np.float32) * \
        (rng.random(size=(m, k)) < density)
    return ELLMatrix.from_dense(jnp.asarray(dense)), dense


@pytest.mark.parametrize("m,k", [(300, 2100), (64, 500), (1000, 333),
                                 (513, 1025)])
def test_blocked_roundtrip(m, k):
    ell, dense = _ell(m, k, seed=m + k)
    bell = ell.blocked()
    np.testing.assert_array_equal(np.asarray(bell.to_dense()), dense)


@pytest.mark.parametrize("m,k,n", [(300, 2100, 130), (64, 500, 16),
                                   (513, 1025, 257)])
def test_blocked_matmul_vs_dense(m, k, n):
    ell, dense = _ell(m, k, seed=7 * m + n)
    bell = ell.blocked()
    b = RNG.normal(size=(k, n)).astype(np.float32)
    got = np.asarray(blocked_ell_matmul(bell, jnp.asarray(b), alpha=-0.5))
    want = -0.5 * dense @ b
    scale = np.abs(want).max() or 1.0
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-2)


def test_blocked_duplicate_entries_accumulate():
    from randblas_tpu.sparse_data import COOMatrix, coo_to_ell
    rows = np.array([0, 0, 1, 0], dtype=np.int32)
    cols = np.array([3, 3, 1, 2], dtype=np.int32)
    vals = np.array([1.0, 2.0, 5.0, -1.0], dtype=np.float32)
    coo = COOMatrix.from_arrays(2, 4, rows, cols, vals)
    bell = coo_to_ell(coo).blocked()
    b = jnp.eye(4, dtype=jnp.float32)
    got = np.asarray(blocked_ell_matmul(bell, b))
    want = np.zeros((2, 4), np.float32)
    want[0, 3] = 3.0
    want[0, 2] = -1.0
    want[1, 1] = 5.0
    np.testing.assert_allclose(got, want, atol=1e-2)


def test_blocked_zero_matrix():
    ell = ELLMatrix.from_dense(jnp.zeros((16, 32), jnp.float32))
    bell = ell.blocked()
    b = jnp.asarray(RNG.normal(size=(32, 8)).astype(np.float32))
    got = np.asarray(blocked_ell_matmul(bell, b))
    np.testing.assert_array_equal(got, 0.0)


def test_left_spmm_blocked_ell_route():
    from randblas_tpu.sparse_data import left_spmm
    ell, dense = _ell(80, 300, seed=5)
    bell = ell.blocked()
    b = RNG.normal(size=(300, 24)).astype(np.float32)
    got = np.asarray(left_spmm(bell, jnp.asarray(b)))
    want = dense @ b
    scale = np.abs(want).max() or 1.0
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-2)
    # transposed/offset forms must fail loudly
    with pytest.raises(ValueError, match="BlockedELL"):
        left_spmm(bell, jnp.asarray(RNG.normal(size=(80, 4)),
                                    jnp.float32), op_a="T")


def test_sketch_sparse_right_blocked_ell():
    from randblas_tpu import (DenseDist, DenseSkOp, RNGState,
                              sketch_sparse)
    ell, dense = _ell(60, 200, seed=9)
    bell = ell.blocked()
    S = DenseSkOp(DenseDist(200, 16), RNGState.from_key(2))
    got = np.asarray(sketch_sparse(S, bell, side="right"))
    want = dense @ np.asarray(S.materialize())
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-2)


def test_left_spmm_auto_blocked_ell():
    """Concrete CSR/COO operands take the COO route as they are: no
    BlockedELL conversion happens behind the caller's back (only an
    explicit BlockedELL operand takes the BlockedELL product)."""
    from randblas_tpu.sparse_data import left_spmm
    from randblas_tpu.sparse_data.conversions import coo_to_csr
    from randblas_tpu.sparse_data.ell import ell_to_coo
    ell, dense = _ell(256, 2048, density=0.02, seed=13)
    coo = ell_to_coo(ell)
    b = RNG.normal(size=(2048, 128)).astype(np.float32)
    csr = coo_to_csr(coo)
    got = np.asarray(left_spmm(csr, jnp.asarray(b)))
    want = dense @ b
    scale = np.abs(want).max() or 1.0
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-2)
    assert getattr(csr, "_bell_cache", None) is None


@pytest.mark.parametrize("m,k", [(300, 2100), (64, 500), (513, 1025)])
def test_word_major_to_dense_roundtrip(m, k):
    """Word-major tables describe the same matrix (BlockedELL.word_major)."""
    ell, dense = _ell(m, k, seed=m + 3 * k)
    bell = ell.blocked(word_major=4)
    assert bell.b_rows == 4 * (-(-k // 4))
    np.testing.assert_array_equal(np.asarray(bell.to_dense()), dense)


@pytest.mark.parametrize("k", [500, 1025])  # 1025 % 4 != 0: phantom rows
def test_word_major_matmul_vs_dense(k):
    ell, dense = _ell(128, k, seed=k)
    from randblas_tpu.ops.ell_spmm import to_word_major_rows
    bell = ell.blocked(word_major=4)
    b = RNG.normal(size=(k, 64)).astype(np.float32)
    got = np.asarray(blocked_ell_matmul(
        bell, to_word_major_rows(jnp.asarray(b), 4, k)))
    want = dense @ b
    scale = np.abs(want).max() or 1.0
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-2)


def test_word_major_two_tier_overflow():
    """bw_cap overflow columns stay in storage order (the COO pass reads
    the same word-major operand the slot tables do)."""
    from randblas_tpu.ops.ell_spmm import to_word_major_rows
    ell, dense = _ell(64, 512, density=0.2, seed=21)
    bell = ell.blocked(word_major=4, bw_cap=8)
    assert bell.ovf_nnz > 0
    b = RNG.normal(size=(512, 32)).astype(np.float32)
    got = np.asarray(blocked_ell_matmul(
        bell, to_word_major_rows(jnp.asarray(b), 4, 512)))
    want = dense @ b
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-2)


def test_sketch_sparse_right_word_major():
    """The implicit-operator fast path: plane fill feeds the word-major
    product with zero interleave; values match the natural-order route
    and the densify oracle (dense.skop_word_major_rows)."""
    from randblas_tpu import (DenseDist, DenseDistName, DenseSkOp,
                              RNGState, sketch_sparse)
    from randblas_tpu.dense import skop_word_major_rows
    ell, dense = _ell(60, 250, seed=9)  # 250 % 4 != 0
    bell = ell.blocked(word_major=4)
    S = DenseSkOp(DenseDist(250, 16), RNGState.from_key(2))
    # the fill-side producer agrees with materialize() on real rows
    wm = skop_word_major_rows(S, 4)
    nblk = bell.b_rows // 4
    s_of_k = (np.arange(250) % 4) * nblk + np.arange(250) // 4
    np.testing.assert_array_equal(np.asarray(wm)[s_of_k],
                                  np.asarray(S.materialize()))
    got = np.asarray(sketch_sparse(S, bell, side="right"))
    want = dense @ np.asarray(S.materialize())
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-2)
    # transposed-operator fallback (generic reorder, wide RowMajor op)
    St = DenseSkOp(DenseDist(16, 250), RNGState.from_key(5))
    got_t = np.asarray(sketch_sparse(St, bell, side="right", op_s="T"))
    want_t = dense @ np.asarray(St.materialize()).T
    np.testing.assert_allclose(got_t / scale, want_t / scale, atol=2e-2)
    # uniform family through the plane fill
    Su = DenseSkOp(DenseDist(250, 16, DenseDistName.Uniform),
                   RNGState.from_key(3))
    got_u = np.asarray(sketch_sparse(Su, bell, side="right"))
    want_u = dense @ np.asarray(Su.materialize())
    scale_u = np.abs(want_u).max()
    np.testing.assert_allclose(got_u / scale_u, want_u / scale_u,
                               atol=2e-2)


def test_word_major_phantom_rows_are_zero():
    """Operator height one short of the bell's column count within the
    same 4-block: the plane fill's phantom storage rows must be ZERO, or
    the bell's last real column multiplies generated garbage
    (code-review finding; the padding invariant)."""
    from randblas_tpu import DenseDist, DenseSkOp, RNGState, sketch_sparse
    from randblas_tpu.dense import skop_word_major_rows

    ell, dense = _ell(32, 250, seed=77)
    bell = ell.blocked(word_major=4)
    S = DenseSkOp(DenseDist(249, 16), RNGState.from_key(4))
    wm = skop_word_major_rows(S, 4)
    nblk = wm.shape[0] // 4
    k_of_s = (np.arange(wm.shape[0]) % nblk) * 4 + np.arange(
        wm.shape[0]) // nblk
    assert np.all(np.asarray(wm)[k_of_s >= 249] == 0.0)
    # end to end: window semantics (data col 249 multiplies zero)
    got = np.asarray(sketch_sparse(S, bell, side="right"))
    want = dense[:, :249] @ np.asarray(S.materialize())
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-2)


def test_word_major_left_side():
    """side='left' sketch_sparse must hand the word-major product a
    storage-ordered operand too (code-review finding)."""
    from randblas_tpu import DenseDist, DenseSkOp, RNGState, sketch_sparse
    ell, dense = _ell(32, 256, seed=13)
    bell = ell.blocked(word_major=4)
    S = DenseSkOp(DenseDist(16, 256), RNGState.from_key(5))
    # B = S @ A^T: the operand handed to the product is S^T-derived
    got = np.asarray(sketch_sparse(S, bell, side="left", op_a="T"))
    want = np.asarray(S.materialize()) @ dense.T
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-2)
    # and a tall operator entering with op_s='T' (full-op fast path)
    St = DenseSkOp(DenseDist(256, 16), RNGState.from_key(6))
    got_t = np.asarray(sketch_sparse(St, bell, side="left", op_s="T",
                                     op_a="T"))
    want_t = np.asarray(St.materialize()).T @ dense.T
    scale_t = np.abs(want_t).max()
    np.testing.assert_allclose(got_t / scale_t, want_t / scale_t,
                               atol=2e-2)
