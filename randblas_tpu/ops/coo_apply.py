"""COO x dense products via gather + segment-sum or scatter-densify + GEMM.

The accelerator answer to the reference's CPU saxpy loops
(coo_spmm_impl.hh:80-162, csc_spmm_impl.hh:44-153, csr_spmm_impl.hh:46-156):
instead of looping nonzeros with scalar axpys, gather the needed rows of the
dense operand, scale by the nonzero values, and reduce with an XLA
segment-sum (one fused scatter-add). Submatrix selection is handled by
masking — nnz stays static under jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Linearized scatter indices are int32 (x64 stays off for kernel
# throughput); targets at or above this element count route through
# the 2-D (row, col) scatter instead. Module-level so tests can
# lower it to exercise the fallback at small shapes.
_FLAT_SCATTER_LIMIT = 2 ** 31


def coo_left_apply(
    rows: jax.Array,
    cols: jax.Array,
    vals: jax.Array,
    b: jax.Array,          # (m, n) dense operand, already op()-resolved
    d: int,
    m: int,
    ro: int = 0,
    co: int = 0,
    alpha=1.0,
) -> jax.Array:
    """alpha * submat(Asp)[ro:ro+d, co:co+m] @ b, returned as (d, n).

    Entries of the COO triplets outside the submatrix window are masked to
    zero (shape-static analogue of set_filtered_coo, coo_spmm_impl.hh:46-75).
    """
    r = rows.astype(jnp.int32) - jnp.int32(ro)
    c = cols.astype(jnp.int32) - jnp.int32(co)
    mask = (r >= 0) & (r < d) & (c >= 0) & (c < m)
    w = jnp.where(mask, vals, jnp.zeros((), dtype=vals.dtype))
    r_safe = jnp.where(mask, r, 0)
    c_safe = jnp.where(mask, c, 0)
    contrib = w[:, None] * b[c_safe]          # (nnz, n) gather + scale
    out = jax.ops.segment_sum(contrib, r_safe, num_segments=d)
    alpha = jnp.asarray(alpha, dtype=b.dtype)
    return alpha * out.astype(b.dtype)


# Memory budget (elements) for the one-shot densified operator of
# coo_left_apply_dense: 2^28 f32 elements = 1 GB.
_DENSE_BUDGET = 1 << 28


def coo_left_apply_dense(
    rows: jax.Array,
    cols: jax.Array,
    vals: jax.Array,
    b: jax.Array,          # (m, n)
    d: int,
    m: int,
    ro: int = 0,
    co: int = 0,
    alpha=1.0,
) -> jax.Array:
    """alpha * submat(Asp) @ b via ONE flat scatter-add into the full
    (d, m) densified operator + one GEMM: each index is scattered once,
    where the panel variant re-scatters all nnz indices per panel.
    """
    r = rows.astype(jnp.int32) - jnp.int32(ro)
    c = cols.astype(jnp.int32) - jnp.int32(co)
    mask = (r >= 0) & (r < d) & (c >= 0) & (c < m)
    w = jnp.where(mask, vals, jnp.zeros((), vals.dtype)).astype(b.dtype)
    if d * m < _FLAT_SCATTER_LIMIT:
        idx = jnp.where(mask, r * jnp.int32(m) + c, 0)
        dense = jnp.zeros((d * m,), b.dtype).at[idx].add(w).reshape(d, m)
    else:
        # linearized int32 index would overflow; 2-D scatter has no limit
        rr = jnp.where(mask, r, 0)
        cc = jnp.where(mask, c, 0)
        dense = jnp.zeros((d, m), b.dtype).at[rr, cc].add(w)
    out = jnp.matmul(dense, b, preferred_element_type=b.dtype)
    return jnp.asarray(alpha, b.dtype) * out


def coo_left_apply_panels(
    rows: jax.Array,
    cols: jax.Array,
    vals: jax.Array,
    b: jax.Array,          # (m, n)
    d: int,
    m: int,
    ro: int = 0,
    co: int = 0,
    alpha=1.0,
    panel: int = 8192,
) -> jax.Array:
    """alpha * submat(Asp) @ b via densified operator *panels* + GEMM.

    For sketching-shaped operands (small d, large m, many output columns)
    this beats gather/segment-sum by orders of magnitude: segment-sum moves
    nnz*n elements through device memory, while densify-panels moves d*m
    (the panel scatters) plus one GEMM. Dispatch is
    in coo_left_apply_auto.
    """
    r = rows.astype(jnp.int32) - jnp.int32(ro)
    c = cols.astype(jnp.int32) - jnp.int32(co)
    window = (r >= 0) & (r < d) & (c >= 0) & (c < m)
    w_all = jnp.where(window, vals, jnp.zeros((), vals.dtype)).astype(
        b.dtype)
    panel = min(panel, m)
    n_panels = -(-m // panel)
    m_pad = n_panels * panel
    n = b.shape[1]
    b_pad = jnp.pad(b, ((0, m_pad - m), (0, 0))) if m_pad != m else b

    flat_ok = d * panel < _FLAT_SCATTER_LIMIT  # int32 linear index wraps

    def step(acc, p):
        c0 = p * panel
        in_panel = (c >= c0) & (c < c0 + panel)
        w = jnp.where(in_panel, w_all, jnp.zeros((), b.dtype))
        if flat_ok:
            # linearized 1-D scatter index
            idx = jnp.where(in_panel & window,
                            r * jnp.int32(panel) + (c - c0), 0)
            s_panel = jnp.zeros((d * panel,), b.dtype).at[idx].add(w)
            s_panel = s_panel.reshape(d, panel)
        else:
            rr = jnp.where(in_panel & window, r, 0)
            cc = jnp.where(in_panel & window, c - c0, 0)
            s_panel = jnp.zeros((d, panel), b.dtype).at[rr, cc].add(w)
        b_panel = jax.lax.dynamic_slice(b_pad, (c0, 0), (panel, n))
        acc = acc + jnp.matmul(s_panel, b_panel,
                               preferred_element_type=b.dtype)
        return acc, None

    acc0 = jnp.zeros((d, n), dtype=b.dtype)
    acc, _ = jax.lax.scan(step, acc0, jnp.arange(n_panels))
    return jnp.asarray(alpha, b.dtype) * acc


def fixed_nnz_left_apply(
    idxs_major: jax.Array,   # (m, k) output-row index per data row, per t
    vals: jax.Array,         # (m, k) +-1 values
    b: jax.Array,            # (m, n)
    d: int,
    alpha=1.0,
) -> jax.Array:
    """SASO-wide apply via the fixed-nnz structure: every data row c
    contributes to exactly k output rows, so S @ b = sum_t
    segment_sum(vals[:, t] * b, idxs_major[:, t]) — k reweighted passes
    over b, no nnz*n gather blowup and no scatter into operator panels.
    The counterpart of the reference's "regular CSC" fast path
    (csc_spmm_impl.hh:68-88). Indices outside [0, d) are dropped.
    """
    k = idxs_major.shape[1]

    def step(acc, t):
        w = vals[:, t].astype(b.dtype)
        contrib = jax.ops.segment_sum(w[:, None] * b,
                                      idxs_major[:, t].astype(jnp.int32),
                                      num_segments=d)
        return acc + contrib, None

    acc0 = jnp.zeros((d, b.shape[1]), dtype=b.dtype)
    acc, _ = jax.lax.scan(step, acc0, jnp.arange(k))
    return jnp.asarray(alpha, b.dtype) * acc


def onehot_panel_apply(
    idxs_major: jax.Array,   # (m, k) output-row index per data row
    vals: jax.Array,         # (m, k) +-1 values
    b: jax.Array,            # (m, n)
    d: int,
    alpha=1.0,
    panel: int = 4096,
) -> jax.Array:
    """SASO-wide apply as one-hot GEMMs: operator panels are built with
    iota==index compares (elementwise, no scatter anywhere) and
    contracted with a GEMM. Indices outside [0, d) match no row.

    S_panel[r, c] = sum_t vals[c, t] * [idxs_major[c, t] == r], then
    B += S_panel @ b_panel. The faster of the two wide-SASO routes on the
    H100 at config 3's shape (PERF.md).
    """
    m, k = idxs_major.shape
    n = b.shape[1]
    panel = min(panel, m)
    n_p = -(-m // panel)
    m_pad = n_p * panel
    if m_pad != m:
        b = jnp.pad(b, ((0, m_pad - m), (0, 0)))
        idxs_major = jnp.pad(idxs_major, ((0, m_pad - m), (0, 0)),
                             constant_values=-1)
        vals = jnp.pad(vals, ((0, m_pad - m), (0, 0)))
    row_iota = jax.lax.broadcasted_iota(jnp.int32, (d, panel), 0)

    def step(acc, p):
        c0 = p * panel
        rp = jax.lax.dynamic_slice(idxs_major, (c0, 0), (panel, k))
        vp = jax.lax.dynamic_slice(vals, (c0, 0), (panel, k)).astype(
            b.dtype)
        s_panel = jnp.zeros((d, panel), dtype=b.dtype)
        for t in range(k):
            s_panel = s_panel + jnp.where(
                row_iota == rp[:, t].astype(jnp.int32)[None, :],
                vp[:, t][None, :], jnp.zeros((), b.dtype))
        b_p = jax.lax.dynamic_slice(b, (c0, 0), (panel, n))
        acc = acc + jnp.matmul(s_panel, b_p, preferred_element_type=b.dtype)
        return acc, None

    acc0 = jnp.zeros((d, n), dtype=b.dtype)
    acc, _ = jax.lax.scan(step, acc0, jnp.arange(n_p))
    return jnp.asarray(alpha, b.dtype) * acc


def row_gather_apply(
    idxs_major: jax.Array,   # (d, k) data-row index per output row
    vals: jax.Array,         # (d, k)
    b: jax.Array,            # (m, n)
    alpha=1.0,
) -> jax.Array:
    """Tall-SASO apply: each output row reads exactly k data rows —
    a pure gather + weighted sum (no reduction conflicts at all).
    B[r] = sum_t vals[r, t] * b[idxs_major[r, t]]."""
    d, k = idxs_major.shape
    acc = jnp.zeros((d, b.shape[1]), dtype=b.dtype)
    for t in range(k):
        acc = acc + vals[:, t].astype(b.dtype)[:, None] * \
            b[idxs_major[:, t]]
    return jnp.asarray(alpha, b.dtype) * acc


def coo_left_apply_auto(rows, cols, vals, b, d, m, ro=0, co=0, alpha=1.0
                        ) -> jax.Array:
    """Heuristic dispatch between gather/segment-sum (cheap for skinny b)
    and densify + GEMM (cheap for wide b). The densify route scatters
    ONCE into the full (d, m) operator when that buffer fits the memory
    budget; the panel variant (re-scatters all nnz per panel) is only
    the fallback for operators too large to densify whole."""
    nnz = rows.shape[0]
    n = b.shape[1]
    # segment-sum traffic ~ nnz*n; densify traffic ~ d*m + GEMM flops.
    if nnz * n > 4 * d * m or (n >= 64 and nnz * n > (1 << 22)):
        if d * m <= _DENSE_BUDGET:
            return coo_left_apply_dense(rows, cols, vals, b, d, m, ro, co,
                                        alpha)
        return coo_left_apply_panels(rows, cols, vals, b, d, m, ro, co,
                                     alpha)
    return coo_left_apply(rows, cols, vals, b, d, m, ro, co, alpha)


def coo_densify(
    rows: jax.Array,
    cols: jax.Array,
    vals: jax.Array,
    n_rows: int,
    n_cols: int,
    ro: int = 0,
    co: int = 0,
    dtype=None,
) -> jax.Array:
    """Dense (n_rows, n_cols) block of the COO matrix starting at (ro, co).

    Used by the one-hot path for short sketch dimensions and by test
    oracles (counterpart of coo_to_dense, coo_matrix.hh:350-380).
    """
    dtype = vals.dtype if dtype is None else dtype
    r = rows.astype(jnp.int32) - jnp.int32(ro)
    c = cols.astype(jnp.int32) - jnp.int32(co)
    mask = (r >= 0) & (r < n_rows) & (c >= 0) & (c < n_cols)
    w = jnp.where(mask, vals, jnp.zeros((), dtype=vals.dtype)).astype(dtype)
    r_safe = jnp.where(mask, r, 0)
    c_safe = jnp.where(mask, c, 0)
    dense = jnp.zeros((n_rows, n_cols), dtype=dtype)
    return dense.at[r_safe, c_safe].add(w)
