"""sketch_sparse: dense sketching operators applied to sparse data matrices.

Counterpart of RandBLAS/sparse_data/sksp.hh (lsksp3 :148-192,
rsksp3 :303-345, sketch_sparse :465-485,596-616). The dense operator block
is generated from counters (never the full operator), then combined with the
sparse data through the SpMM path.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .base import Op, Side, dims_before_op, require
from .dense import DenseSkOp
from .skge import _as_op, _as_side
from .sparse_data.spmm import left_spmm, right_spmm


def _storage_order_operand(A, S, op_s, rows_s, cols_s, ro_s, co_s,
                           transpose_out):
    """The dense-operator operand for a word-major BlockedELL product, in
    the bell's storage row order (BlockedELL.word_major).

    transpose_out: whether the natural-order operand would be the
    TRANSPOSE of the stored block. The zero-interleave fast path applies
    when the operand equals the FULL operator in its natural orientation
    (the plane fill produces exactly that order for free —
    dense.skop_word_major_rows); every other case reorders the natural
    block generically (ops/ell_spmm.py::to_word_major_rows)."""
    from .dense import skop_word_major_rows
    from .ops import ell_spmm

    full = (ro_s == 0 and co_s == 0 and rows_s == S.n_rows
            and cols_s == S.n_cols)
    if full and not transpose_out:
        wm = skop_word_major_rows(S, A.word_major)
        if wm is not None:
            return wm
    blk = S.submat(rows_s, cols_s, ro_s, co_s)
    if transpose_out:
        blk = blk.T
    return ell_spmm.to_word_major_rows(blk, A.word_major, blk.shape[0])


def sketch_sparse(
    S: DenseSkOp,
    A,  # sparse matrix (COO/CSR/CSC)
    *,
    side="left",
    op_s="N",
    op_a="N",
    alpha=1.0,
    beta=0.0,
    out: Optional[jax.Array] = None,
    d: Optional[int] = None,
    m: Optional[int] = None,
    n: Optional[int] = None,
    ro_s: int = 0,
    co_s: int = 0,
    ro_a: int = 0,
    co_a: int = 0,
) -> jax.Array:
    """left:  B = alpha * op_s(submat(S)) @ op_a(submat(A)) + beta * B
    right: B = alpha * op_a(submat(A)) @ op_s(submat(S)) + beta * B

    S is a *dense* sketching operator; A is sparse data. Dimension
    conventions follow lsksp3/rsksp3 (sksp.hh:148,303): for the left side,
    B is d x n and op_s(submat(S)) is d x m; `m` defaults to the operator's
    remaining extent after (ro_s, co_s) and `n` to the data's remaining
    extent after (ro_a, co_a). The reference restricts data submatrices to
    COO; here offsets work for all formats.
    """
    side = _as_side(side)
    op_s = _as_op(op_s)
    op_a = _as_op(op_a)
    require(isinstance(S, DenseSkOp),
            "sketch_sparse takes a dense sketching operator")
    if out is None:
        require(isinstance(beta, (int, float)) and beta == 0,
                "beta != 0 requires an `out` array to accumulate into")
    coo_rows = A.n_rows
    coo_cols = A.n_cols
    # operator extents remaining after the submatrix offsets
    s_rows_av = S.n_rows - ro_s
    s_cols_av = S.n_cols - co_s
    if side == Side.Left:
        # need op_s(submat(S)) (d x m), op_a(submat(A)) (m x n)
        if d is None:
            d = out.shape[0] if out is not None else (
                s_rows_av if op_s == Op.NoTrans else s_cols_av)
        if m is None:
            m = s_cols_av if op_s == Op.NoTrans else s_rows_av
            data_rows_av = (coo_rows - ro_a if op_a == Op.NoTrans
                            else coo_cols - co_a)
            m = min(m, data_rows_av)
        if n is None:
            n = (out.shape[1] if out is not None else
                 (coo_cols - co_a if op_a == Op.NoTrans else
                  coo_rows - ro_a))
        rows_a_need = m if op_a == Op.NoTrans else n
        cols_a_need = n if op_a == Op.NoTrans else m
        require(coo_rows >= rows_a_need + ro_a, "A row range out of bounds")
        require(coo_cols >= cols_a_need + co_a,
                "A column range out of bounds")
        rows_s, cols_s = dims_before_op(d, m, op_s)
        require(S.n_rows >= rows_s + ro_s, "S row range out of bounds")
        require(S.n_cols >= cols_s + co_s, "S column range out of bounds")
        # B = op_s(submat(S)) @ op_a(submat(A)) = right_spmm reduction:
        # (op_a(submat(A))^T @ op_s(submat(S))^T)^T via left_spmm on
        # flipped op. The operand handed to left_spmm is op_s(submat)^T:
        # submat^T for NoTrans, submat itself for Trans.
        from .ops import ell_spmm
        if isinstance(A, ell_spmm.BlockedELL) and A.word_major:
            s_opnd = _storage_order_operand(
                A, S, op_s, rows_s, cols_s, ro_s, co_s,
                transpose_out=(op_s == Op.NoTrans))
        else:
            s_opnd = S.submat(rows_s, cols_s, ro_s, co_s)
            if op_s == Op.NoTrans:
                s_opnd = s_opnd.T
        flip_a = Op.NoTrans if op_a == Op.Trans else Op.Trans
        prod = left_spmm(A, s_opnd, op_a=flip_a, alpha=alpha, d=n,
                         ro_a=ro_a, co_a=co_a).T
        expected = (d, n)
    else:
        # B = op_a(submat(A)) (m x n) @ op_s(submat(S)) (n x d)
        if d is None:
            d = out.shape[1] if out is not None else (
                s_cols_av if op_s == Op.NoTrans else s_rows_av)
        if n is None:
            n = s_rows_av if op_s == Op.NoTrans else s_cols_av
            data_cols_av = (coo_cols - co_a if op_a == Op.NoTrans
                            else coo_rows - ro_a)
            n = min(n, data_cols_av)
        if m is None:
            m = (out.shape[0] if out is not None else
                 (coo_rows - ro_a if op_a == Op.NoTrans else
                  coo_cols - co_a))
        rows_a_need = m if op_a == Op.NoTrans else n
        cols_a_need = n if op_a == Op.NoTrans else m
        require(coo_rows >= rows_a_need + ro_a, "A row range out of bounds")
        require(coo_cols >= cols_a_need + co_a,
                "A column range out of bounds")
        rows_s, cols_s = dims_before_op(n, d, op_s)
        require(S.n_rows >= rows_s + ro_s, "S row range out of bounds")
        require(S.n_cols >= cols_s + co_s, "S column range out of bounds")
        from .ops import ell_spmm
        if isinstance(A, ell_spmm.BlockedELL) and A.word_major:
            # word-major operand storage: the plane fill produces it with
            # zero interleave (the natural order costs a ~2 ms relayout
            # into pallas_call at the config-4 shape — BlockedELL.word_major)
            s_blk = _storage_order_operand(
                A, S, op_s, rows_s, cols_s, ro_s, co_s,
                transpose_out=(op_s == Op.Trans))
        else:
            s_blk = S.submat(rows_s, cols_s, ro_s, co_s)
            if op_s == Op.Trans:
                s_blk = s_blk.T
        # B = op_a(submat(A)) @ s_blk: left_spmm with the sparse operand
        prod = left_spmm(A, s_blk, op_a=op_a, alpha=alpha, d=m,
                         ro_a=ro_a, co_a=co_a)
        expected = (m, d)

    if out is not None:
        require(tuple(out.shape) == expected,
                f"out has shape {out.shape}, expected {expected}")
        from .ops.accumulate import accumulate
        return accumulate(prod, beta, out)
    return prod
