"""SpMM: sparse x dense products with submatrix offsets and op flags.

Counterpart of RandBLAS/sparse_data/spmm_dispatch.hh (left_spmm
:49-160, right_spmm :163-200, public spmm :291,381). Every format funnels
into the XLA COO apply (ops/coo_apply.py: gather/segment-sum or
scatter-densify + GEMM) in place of the reference's per-format CPU
kernels; transposes are zero-copy index-role swaps like the reference's
transposed views.

NOTE: the reference's right-sided `spmm` wrapper has an argument bug
(spmm_dispatch.hh:382 passes B twice) — intentionally not replicated.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..base import Op, require
from ..ops.coo_apply import coo_left_apply_auto as coo_left_apply
from .conversions import to_coo


def _as_op(op) -> Op:
    if isinstance(op, Op):
        return op
    s = str(op).strip().upper()
    if s in ("N", "NOTRANS"):
        return Op.NoTrans
    if s in ("T", "TRANS"):
        return Op.Trans
    raise ValueError(f"invalid op: {op!r}")


def left_spmm(
    A,                      # sparse: COO/CSR/CSC matrix or SparseSkOp
    B: jax.Array,           # dense (stored shape; op_b transposes)
    *,
    op_a="N",
    op_b="N",
    alpha=1.0,
    beta=0.0,
    out: Optional[jax.Array] = None,
    d: Optional[int] = None,
    ro_a: int = 0,
    co_a: int = 0,
) -> jax.Array:
    """C = alpha * op_a(submat(A))[d x m] @ op_b(B)[m x n] + beta * C.

    d defaults to the full (possibly transposed) sparse operand height.
    Unlike the reference, submatrix offsets are supported for every format
    (they are masks here, not pointer arithmetic).
    """
    op_a = _as_op(op_a)
    op_b = _as_op(op_b)
    B = jnp.asarray(B)
    require(B.ndim == 2, "B must be 2-D")
    from ..ops import ell_spmm
    if isinstance(A, ell_spmm.BlockedELL):
        require(op_a == Op.NoTrans and ro_a == 0 and co_a == 0
                and (d is None or d == A.n_rows),
                "BlockedELL supports full untransposed left products; "
                "use to_coo() for general forms")
        b_mat = B if op_b == Op.NoTrans else B.T
        require(A.b_rows == b_mat.shape[0],
                "inner dimension mismatch (word-major operands must be in "
                "storage order, ops/ell_spmm.py::to_word_major_rows)")
        prod = ell_spmm.blocked_ell_matmul(A, b_mat, alpha)
        if out is not None:
            require(tuple(out.shape) == prod.shape, "out shape mismatch")
            from ..ops.accumulate import accumulate
            return accumulate(prod, beta, out)
        return prod
    from .ell import ELLMatrix
    if (isinstance(A, ELLMatrix) and op_a == Op.NoTrans
            and ro_a == 0 and co_a == 0
            and (d is None or d == A.n_rows)):
        # gather fast path: full untransposed ELL operand
        b_mat = B if op_b == Op.NoTrans else B.T
        require(A.n_cols == b_mat.shape[0], "inner dimension mismatch")
        prod = A.matmul(b_mat, alpha)
        if out is not None:
            require(tuple(out.shape) == prod.shape, "out shape mismatch")
            from ..ops.accumulate import accumulate
            return accumulate(prod, beta, out)
        return prod
    coo = to_coo(A)
    rows, cols = coo.rows, coo.cols
    n_rows_a, n_cols_a = coo.n_rows, coo.n_cols
    if op_a == Op.Trans:
        rows, cols = cols, rows
        ro_a, co_a = co_a, ro_a
        n_rows_a, n_cols_a = n_cols_a, n_rows_a
    b_mat = B if op_b == Op.NoTrans else B.T
    m, n = b_mat.shape
    if d is None:
        d = out.shape[0] if out is not None else n_rows_a - ro_a
    require(n_rows_a >= d + ro_a, "sparse row range out of bounds")
    require(n_cols_a >= m + co_a, "sparse column range out of bounds")
    prod = coo_left_apply(rows, cols, coo.vals.astype(b_mat.dtype), b_mat,
                          d, m, ro_a, co_a, alpha)
    if out is not None:
        require(tuple(out.shape) == (d, n), "out shape mismatch")
        from ..ops.accumulate import accumulate
        return accumulate(prod, beta, out)
    return prod


def right_spmm(
    A: jax.Array,           # dense
    B,                      # sparse
    *,
    op_a="N",
    op_b="N",
    alpha=1.0,
    beta=0.0,
    out: Optional[jax.Array] = None,
    d: Optional[int] = None,
    ro_b: int = 0,
    co_b: int = 0,
) -> jax.Array:
    """C = alpha * op_a(A)[m x k] @ op_b(submat(B))[k x d] + beta * C.

    Reduces to left_spmm on the transpose (spmm_dispatch.hh:163-200):
    C^T = op_b(submat(B))^T @ op_a(A)^T.
    """
    op_a = _as_op(op_a)
    op_b = _as_op(op_b)
    A = jnp.asarray(A)
    a_mat = A if op_a == Op.NoTrans else A.T
    # offsets pass through unchanged: left_spmm swaps them itself when the
    # flipped op is Trans, exactly like the reference's reduction, which
    # forwards (i_off, j_off) verbatim (spmm_dispatch.hh:196-199).
    flip_b = Op.NoTrans if op_b == Op.Trans else Op.Trans
    ct = left_spmm(B, a_mat.T, op_a=flip_b, op_b=Op.NoTrans, alpha=alpha,
                   d=d, ro_a=ro_b, co_a=co_b)
    prod = ct.T
    if out is not None:
        require(tuple(out.shape) == prod.shape, "out shape mismatch")
        from ..ops.accumulate import accumulate
        return accumulate(prod, beta, out)
    return prod


def spmm(A, B, *, side="left", **kwargs) -> jax.Array:
    """Public SpMM wrapper (spmm_dispatch.hh:291,381 — minus the :382 bug):
    side='left' -> sparse @ dense, side='right' -> dense @ sparse."""
    s = str(side).strip().lower()
    if s in ("l", "left"):
        return left_spmm(A, B, **kwargs)
    if s in ("r", "right"):
        return right_spmm(A, B, **kwargs)
    raise ValueError(f"invalid side: {side!r}")
