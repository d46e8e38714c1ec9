"""sketch_general: the primary sketching entry point.

Counterpart of RandBLAS/skge.hh (sketch_general overload set,
lskge3/rskge3 :174-364, lskges/rskges :486-641). Functional semantics:

    left:  B_new = alpha * op_s(submat(S)) @ op_a(A) + beta * B
    right: B_new = alpha * op_a(A) @ op_s(submat(S)) + beta * B

where A and B are ordinary jnp arrays (row-major, shape == math shape) and
S is a DenseSkOp or SparseSkOp. The BLAS-style (layout, ld, flat-buffer)
surface lives in randblas_tpu.compat for porting the reference test matrix.

Dense operators dispatch to a GEMM whose left operand is generated from
counters (a lazily materialized block, or on the GPU, where it pays, the
RNG-in-GEMM kernel that never writes the operator to device memory);
sparse operators dispatch to XLA gather/segment-sum/one-hot routes.
"""

from __future__ import annotations

from typing import Optional, Union

import jax
import jax.numpy as jnp

from . import backend
from .base import Op, Side, dims_before_op, require
from .dense import DenseSkOp
from .ops.coo_apply import coo_left_apply_auto as coo_left_apply
from .sparse import SparseSkOp
from .trig import TrigSkOp

SkOp = Union[DenseSkOp, SparseSkOp, TrigSkOp]

# Fused-kernel dispatch policy: "auto" runs the RNG-in-GEMM kernel
# (ops/fused_sketch.py) on the GPU where it measured faster than the
# staged fill + GEMM (fused_profitable); True forces it (errors if the
# call is unsupported); False always materializes the operator block.
use_fused = "auto"

# f64 GEMM policy: True routes float64 dense products through the
# int8-sliced GEMM (ops/f64gemm.py); "auto" and False use the native
# f64 matmul.
use_hiprec_f64 = "auto"

# Wide-SASO apply route per backend (ops/coo_apply.py): "onehot" builds
# one-hot operator panels and contracts them with a GEMM; "segsum" runs
# one segment-sum pass per nonzero slot. The GPU entry is the faster of
# the two at config 3's shape on the H100 (PERF.md).
SASO_ROUTE = {"gpu": "onehot", "cpu": "segsum"}


def _saso_wide_apply(idx, w, b_mat, d: int, alpha):
    """alpha * S @ b_mat for a wide operator with k nonzeros per column:
    idx/w are (m, k) row indices and values; an index outside [0, d)
    contributes nothing."""
    from .ops.coo_apply import fixed_nnz_left_apply, onehot_panel_apply
    if SASO_ROUTE.get(backend.platform(), "segsum") == "onehot":
        return onehot_panel_apply(idx, w, b_mat, d, alpha)
    return fixed_nnz_left_apply(idx, w, b_mat, d, alpha)


def _as_op(op) -> Op:
    if isinstance(op, Op):
        return op
    if isinstance(op, str):
        s = op.strip().upper()
        if s in ("N", "NOTRANS"):
            return Op.NoTrans
        if s in ("T", "TRANS"):
            return Op.Trans
    raise ValueError(f"invalid op: {op!r}")


def _as_side(side) -> Side:
    if isinstance(side, Side):
        return side
    s = str(side).strip().lower()
    if s in ("l", "left"):
        return Side.Left
    if s in ("r", "right"):
        return Side.Right
    raise ValueError(f"invalid side: {side!r}")


def _dense_block(S: DenseSkOp, rows_s: int, cols_s: int, ro_s: int,
                 co_s: int, op_s: Op, dtype) -> jax.Array:
    """op_s(submat(S)) as a dense array (lazy counter-addressed fill).

    On the high-precision f64 route, lazily generated GAUSSIAN blocks
    stay f32: their values ARE f32-exact (the reference also generates in
    float and promotes, dense_skops.hh:50-55) and _matmul slices f32
    operands to full f64 depth — this halves the block's footprint.
    Uniform is excluded: its sqrt(3) scale is applied in the target dtype
    (matching the reference's T-typed scal, dense_skops.hh:512), so f64
    Uniform values are not f32-representable."""
    from .dense import DenseDistName
    blk_dtype = dtype
    if (_hiprec_route(dtype) and S.materialized is None
            and S.dist.family == DenseDistName.Gaussian
            and not S.seed_state.is_x64):
        # x64 seeds are excluded: their streams are NATIVE f64
        # (rng/x64.py), not f32-exact values promoted
        blk_dtype = jnp.float32
    blk = S.submat(rows_s, cols_s, ro_s, co_s, dtype=blk_dtype)
    return blk.T if op_s == Op.Trans else blk


def _hiprec_route(dtype) -> bool:
    return jnp.dtype(dtype) == jnp.float64 and use_hiprec_f64 is True


def _matmul(a, b, dtype):
    if _hiprec_route(dtype):
        from .ops.f64gemm import matmul_hiprec
        # an f32 operand here means "f32-exact values under fp64 GEMM
        # semantics" (lazily generated operator blocks): slice to full
        # f64 depth, not the 4-level f32-accuracy default. NOTE 4
        # slices are NOT enough even though each value has only 24
        # mantissa bits: slice levels align to the ROW max, so a
        # small-magnitude entry's bits extend into slices 4..7
        # (measured: sa=4 costs 8 digits of accuracy).
        kw = {}
        if a.dtype == jnp.float32:
            kw["slices_a"] = 8
        if b.dtype == jnp.float32:
            kw["slices_b"] = 8
        return matmul_hiprec(a, b, **kw)
    return jnp.matmul(a, b, preferred_element_type=dtype)


def _fused_or_none(S: DenseSkOp, a_mat, rows_s: int, cols_s: int,
                   ro_s: int, co_s: int, op_s: Op, dtype, alpha):
    """alpha * op_s(block(S)) @ a_mat through the RNG-in-GEMM kernel, or
    None when the staged fill + GEMM should run.

    op_s == Trans uses the fill-order autotranspose property (tested in
    test_dense_fill.py): block(S, r, c, ro, co)^T == block(S_t, c, r, co,
    ro) for the transposed distribution S_t with the same seed, whose
    natural layout is the other one. A square distribution transposes to
    itself, so the identity does not hold there and it stays staged.
    """
    if use_fused is False or S.materialized is not None:
        return None
    from .ops import fused_sketch as fs
    if op_s == Op.Trans:
        from .dense import DenseDist
        if S.dist.n_rows == S.dist.n_cols:
            return None
        dist_t = DenseDist(S.dist.n_cols, S.dist.n_rows, S.dist.family,
                           S.dist.major_axis)
        S = DenseSkOp(dist_t, S.seed_state, dtype=S.dtype)
        rows_s, cols_s, ro_s, co_s = cols_s, rows_s, co_s, ro_s
    if not fs.fused_sketch_supported(S.dist, rows_s, cols_s, ro_s, co_s,
                                     dtype, S.seed_state.rng):
        return None
    if use_fused is not True and not (
            backend.on_gpu()
            and fs.fused_profitable(rows_s, cols_s, a_mat.shape[1])):
        return None
    return fs.fused_sketch(S, a_mat, alpha=float(alpha), rows_s=rows_s,
                           cols_s=cols_s, ro_s=ro_s, co_s=co_s)


def _sparse_left_apply(S: SparseSkOp, d: int, m: int, ro_s: int, co_s: int,
                       op_s: Op, b_mat: jax.Array, alpha) -> jax.Array:
    """alpha * op_s(submat(S)) @ b_mat for a sparse-sign operator.

    Counterpart of lskges -> left_spmm (skge.hh:486-510,
    spmm_dispatch.hh:49-160): a transposed operator is handled with a
    zero-copy swap of the COO index roles (+ swapped offsets), exactly like
    the reference's transposed COO view (spmm_dispatch.hh:74-76).
    """
    from .base import MajorAxis
    from .ops.coo_apply import row_gather_apply

    s = S.filled()
    # the reshape-based fast paths assume the canonical per-minor-vector
    # triplet order produced by filled(); user-supplied COO triplets in any
    # other order must take the general COO path (the reference's left_spmm
    # handles arbitrary order, spmm_dispatch.hh:49-160).
    full = (s.canonical
            and op_s == Op.NoTrans and ro_s == 0 and co_s == 0
            and d == S.dist.n_rows and m == S.dist.n_cols
            and S.dist.major_axis == MajorAxis.Short)
    k = S.dist.vec_nnz
    if full and S.dist.n_rows < S.dist.n_cols:
        # wide SASO: fixed nnz per data column ("regular CSC",
        # csc_spmm_impl.hh:68-88)
        return _saso_wide_apply(s.rows.reshape(m, k), s.vals.reshape(m, k),
                                b_mat, d, alpha)
    if full and S.dist.n_rows > S.dist.n_cols:
        # tall SASO: fixed nnz per OUTPUT row -> pure gather
        return row_gather_apply(s.cols.reshape(d, k),
                                s.vals.reshape(d, k), b_mat, alpha)

    # transposed full-operator fast paths (the right-sketch reduction
    # arrives here with op_s == Trans, skge.hh's rskges analog): S^T of
    # a tall-Short SASO is wide with fixed nnz per COLUMN (the wide
    # routes apply), S^T of a wide-Short SASO
    # is tall with fixed nnz per OUTPUT row (pure gather).
    trans_full = (s.canonical
                  and op_s == Op.Trans and ro_s == 0 and co_s == 0
                  and d == S.dist.n_cols and m == S.dist.n_rows
                  and S.dist.major_axis == MajorAxis.Short)
    if trans_full and S.dist.n_rows > S.dist.n_cols:
        # tall S: row r holds k column indices -> S^T has those rows
        # in column r
        return _saso_wide_apply(s.cols.reshape(m, k), s.vals.reshape(m, k),
                                b_mat, d, alpha)
    if trans_full and S.dist.n_rows < S.dist.n_cols:
        # wide S: column c holds k row indices -> S^T row c gathers them
        return row_gather_apply(s.rows.reshape(d, k),
                                s.vals.reshape(d, k), b_mat, alpha)

    rows, cols = s.rows, s.cols
    if op_s == Op.Trans:
        rows, cols = cols, rows
        ro_s, co_s = co_s, ro_s
    return coo_left_apply(rows, cols, s.vals.astype(b_mat.dtype), b_mat,
                          d, m, ro_s, co_s, alpha)


def sketch_general(
    S: SkOp,
    A: jax.Array,
    *,
    side="left",
    op_s="N",
    op_a="N",
    alpha=1.0,
    beta=0.0,
    out: Optional[jax.Array] = None,
    d: Optional[int] = None,
    ro_s: int = 0,
    co_s: int = 0,
) -> jax.Array:
    """Sketch a general dense matrix A from the left or right.

    Args:
      S: sketching operator (DenseSkOp or SparseSkOp).
      A: data matrix, shape = its stored (math) shape; op_a transposes.
      side: 'left'  -> B = alpha op_s(submat(S)) op_a(A) + beta B  (d x n)
            'right' -> B = alpha op_a(A) op_s(submat(S)) + beta B  (n x d)
      d: sketch dimension (rows of B for left / cols for right). Defaults to
         the full-operator size implied by op_s(S); required when out is
         None and a proper submatrix of S is intended.
      ro_s, co_s: submatrix offsets into S (counter-addressed; no
         materialization of the rest of S).
      out: existing B to accumulate into (functional: a new array is
         returned). Must be given whenever beta != 0 — a nonzero beta with
         no B to accumulate into is an error, never silently dropped.

    Returns B_new.
    """
    side = _as_side(side)
    op_s = _as_op(op_s)
    op_a = _as_op(op_a)
    A = jnp.asarray(A)
    require(A.ndim == 2, "A must be 2-D")
    if out is None:
        require(isinstance(beta, (int, float)) and beta == 0,
                "beta != 0 requires an `out` array to accumulate into")
    dtype = A.dtype

    if side == Side.Left:
        # op_a(A) is (m, n)
        m, n = (A.shape if op_a == Op.NoTrans else A.shape[::-1])
        if d is None:
            d = out.shape[0] if out is not None else (
                S.n_rows if op_s == Op.NoTrans else S.n_cols)
        rows_s, cols_s = dims_before_op(d, m, op_s)
        require(S.n_rows >= rows_s + ro_s, "S row range out of bounds")
        require(S.n_cols >= cols_s + co_s, "S column range out of bounds")
        a_mat = A if op_a == Op.NoTrans else A.T
        if isinstance(S, TrigSkOp):
            require(ro_s == 0 and co_s == 0 and (rows_s, cols_s) == S.shape,
                    "TrigSkOp has no submatrix addressing (H mixes all "
                    "rows); apply the full operator")
            raw = S.lmult(a_mat) if op_s == Op.NoTrans else S.lmult_t(a_mat)
            prod = jnp.asarray(alpha, dtype) * raw.astype(dtype)
        elif isinstance(S, SparseSkOp):
            prod = _sparse_left_apply(S, d, m, ro_s, co_s, op_s, a_mat,
                                      alpha)
        else:
            prod = _fused_or_none(S, a_mat, rows_s, cols_s, ro_s, co_s,
                                  op_s, dtype, alpha)
            if prod is None:
                require(use_fused is not True,
                        "fused sketch path forced but call is unsupported")
                s_blk = _dense_block(S, rows_s, cols_s, ro_s, co_s, op_s,
                                     dtype)
                prod = jnp.asarray(alpha, dtype) * _matmul(s_blk, a_mat,
                                                           dtype)
        expected_shape = (d, n)
    else:
        # op_a(A) is (n, d') with op_s(S) (d', d): B = op_a(A) @ op_s(S)
        n, m = (A.shape if op_a == Op.NoTrans else A.shape[::-1])
        if d is None:
            d = out.shape[1] if out is not None else (
                S.n_cols if op_s == Op.NoTrans else S.n_rows)
        rows_s, cols_s = dims_before_op(m, d, op_s)
        require(S.n_rows >= rows_s + ro_s, "S row range out of bounds")
        require(S.n_cols >= cols_s + co_s, "S column range out of bounds")
        a_mat = A if op_a == Op.NoTrans else A.T
        if isinstance(S, TrigSkOp):
            require(ro_s == 0 and co_s == 0 and (rows_s, cols_s) == S.shape,
                    "TrigSkOp has no submatrix addressing (H mixes all "
                    "rows); apply the full operator")
            # A @ op_s(S) = (op_s(S)^T @ A^T)^T
            raw = (S.lmult_t(a_mat.T) if op_s == Op.NoTrans
                   else S.lmult(a_mat.T)).T
            prod = jnp.asarray(alpha, dtype) * raw.astype(dtype)
        elif isinstance(S, SparseSkOp):
            # (A @ op_s(S)) = (op_s(S)^T @ A^T)^T; flip the op to fold the
            # transpose into the COO view (right_spmm reduction,
            # spmm_dispatch.hh:163-200).
            flipped = Op.NoTrans if op_s == Op.Trans else Op.Trans
            prod = _sparse_left_apply(S, d, m, ro_s, co_s, flipped, a_mat.T,
                                      alpha).T
        else:
            # A @ op_s(S) = (flip(op_s)(S) @ A^T)^T
            flipped = Op.NoTrans if op_s == Op.Trans else Op.Trans
            prod = _fused_or_none(S, a_mat.T, rows_s, cols_s, ro_s, co_s,
                                  flipped, dtype, alpha)
            if prod is not None:
                prod = prod.T
            else:
                require(use_fused is not True,
                        "fused sketch path forced but call is unsupported")
                s_blk = _dense_block(S, rows_s, cols_s, ro_s, co_s, op_s,
                                     dtype)
                prod = jnp.asarray(alpha, dtype) * _matmul(a_mat, s_blk,
                                                           dtype)
        expected_shape = (n, d)

    if out is not None:
        require(tuple(out.shape) == expected_shape,
                f"out has shape {out.shape}, expected {expected_shape}")
        from .ops.accumulate import accumulate
        return accumulate(prod, beta, out)
    return prod


def sketch(S: SkOp, A: jax.Array, *, side="left") -> jax.Array:
    """Convenience wrapper: plain S @ A (left) or A @ S (right)."""
    return sketch_general(S, A, side=side)
