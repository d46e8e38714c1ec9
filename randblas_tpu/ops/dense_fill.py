"""Counter-addressed dense fill: the vectorized core of implicit operators.

Counterpart of ``fill_dense_submat_impl`` (dense_skops.hh:97-170).
The reference walks rows with OpenMP and consumes one CBRNG block at a time;
here every (row, block) pair's counter is computed independently from its
position, so the whole submatrix materializes as one batched generator call —
XLA fuses the counter math, the generator rounds, and the float transform
into a single elementwise pipeline. Thread-count invariance becomes
*mesh-shape invariance* for free: a position's value depends only on
(seed, position), never on which device computes it.

Position -> counter mapping (identical to the reference so streams match):
  - The implicit parent matrix is imagined row-major with ``n_cols_parent``
    columns; each row is padded so the padded width is a multiple of the
    counter width W (pad = -n_cols_parent mod W).
  - flat padded index of submatrix start: ptr_padded = ptr + (ptr //
    n_cols_parent) * pad.
  - element (r, c) of the submatrix lives at counter
    seed.counter + ptr_padded // W + r * ((n_cols_parent + pad) // W)
    + (first_block_start + c) // W, lane (first_block_start + c) mod W,
    where first_block_start = ptr_padded mod W.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..rng.bits import ctr_add64, ctr_add64_words, mul64_u32, add64
from ..rng.state import RNGState
from ..rng.transforms import (boxmul_block, boxmul_pair, uneg11,
                              uneg11_block)


def fill_geometry(n_cols_parent: int, n_scols: int, ptr: int, ctr_size: int):
    """Static counter-addressing geometry (all python ints).

    Returns (ctr_mat_start, first_block_start, ctr_stride, nblk, pad).
    """
    pad = (-n_cols_parent) % ctr_size
    ptr_padded = ptr + (ptr // n_cols_parent) * pad
    ctr_mat_start = ptr_padded // ctr_size
    first_block_start = ptr_padded % ctr_size
    ctr_stride = (n_cols_parent + pad) // ctr_size
    nblk = (first_block_start + n_scols - 1) // ctr_size + 1
    return ctr_mat_start, first_block_start, ctr_stride, nblk, pad


def _row_block_offsets(n_srows: int, nblk: int, ctr_stride: int):
    """(row, blk) -> 64-bit counter offsets in u32 limbs, shape
    (n_srows, nblk) each. row * ctr_stride can exceed 2^32 for very
    large operators, so the high word is carried through. Shared by the
    row-major and word-plane fills — the bit-identity contract between
    them rests on this one mapping."""
    rows = jnp.arange(n_srows, dtype=jnp.uint32)
    stride_lo = jnp.uint32(ctr_stride & 0xFFFFFFFF)
    stride_hi_const = (ctr_stride >> 32) & 0xFFFFFFFF
    row_lo, row_hi = mul64_u32(rows, stride_lo)
    if stride_hi_const:
        row_hi = row_hi + rows * jnp.uint32(stride_hi_const)
    blk = jnp.arange(nblk, dtype=jnp.uint32)
    return add64(row_lo[:, None], row_hi[:, None],
                 blk[None, :], jnp.uint32(0))


def fill_rowmajor_bits(
    n_cols_parent: int,
    n_srows: int,
    n_scols: int,
    ptr: int,
    state: RNGState,
):
    """Raw uint32 stream for a row-major submatrix view of the implicit
    parent. Returns uint32[n_srows, nblk, W] blocks plus the lane offset
    (first_block_start) — callers transform then slice.
    """
    ctr_size = state.len_c
    ctr_mat_start, fbs, ctr_stride, nblk, _ = fill_geometry(
        n_cols_parent, n_scols, ptr, ctr_size)

    base = state.incr(ctr_mat_start)
    off_lo, off_hi = _row_block_offsets(n_srows, nblk, ctr_stride)
    counters = ctr_add64(base.counter, off_lo, off_hi)  # (rows, nblk, W)
    bits = base.generate(counters, base.key)
    return bits, fbs


def _transform_flat(bits, transform: str):
    """Apply the float transform to uint32[rows, nblk, W] blocks and merge
    the block axis: float32[rows, nblk*W]."""
    if transform == "boxmul":
        vals = boxmul_block(bits)
    elif transform == "uneg11":
        vals = uneg11_block(bits)
    else:
        raise ValueError(f"unknown transform {transform!r}")
    n_rows_, nblk, w = vals.shape
    return vals.reshape(n_rows_, nblk * w)


# Generated row counts are rounded up to this multiple, with the phantom
# rows sliced off the result: a tile-aligned layout for the generated
# array (its effect on the GPU is not measured). Phantom rows just
# consume later counters and are discarded; kept values are bit-identical.
_ROW_ALIGN = 8


def fill_rowmajor(
    n_cols_parent: int,
    n_srows: int,
    n_scols: int,
    ptr: int,
    state: RNGState,
    transform: str,
):
    """float32[n_srows, n_scols] submatrix of the implicit parent matrix.

    transform: 'boxmul' (iid standard normal) or 'uneg11' (iid U(-1,1)).
    Exactly reproduces the value-to-position mapping of
    fill_dense_submat_impl (dense_skops.hh:97-170). Internally generates
    a sublane-aligned number of rows and discards the excess (_ROW_ALIGN
    above) — counters of kept positions are untouched.
    """
    rows_gen = -(-n_srows // _ROW_ALIGN) * _ROW_ALIGN
    bits, fbs = fill_rowmajor_bits(n_cols_parent, rows_gen, n_scols, ptr,
                                   state)
    flat = _transform_flat(bits, transform)
    return flat[:n_srows, fbs:fbs + n_scols]


def _words_generator(state: RNGState):
    """Word-plane form of the state's generator, or None if it has none.

    Returns f(c0, c1, c2, c3) -> (x0, x1, x2, x3) with the key baked in.
    """
    if state.rng == "philox4x32":
        from ..rng.philox import philox4x32_words
        k = state.key
        return lambda c0, c1, c2, c3: philox4x32_words(
            c0, c1, c2, c3, k[0], k[1])
    if state.rng == "threefry4x32":
        from ..rng.threefry import threefry4x32_words
        k = state.key
        return lambda c0, c1, c2, c3: threefry4x32_words(
            c0, c1, c2, c3, k[0], k[1], k[2], k[3])
    return None


def fill_colmajor_planes(
    n_cols_parent: int,
    n_srows: int,
    n_scols: int,
    ptr: int,
    state: RNGState,
    transform: str,
):
    """Word planes of the transposed fill, or None for W != 4 generators.

    Returns (gs, fbs, rows_gen, nblk): gs is a tuple of 4 float32
    (rows_gen, nblk) planes with
    ``fill_rowmajor(...).T[blk*4 + w, row] == gs[w][row, blk]``
    (before the fbs/n_scols slice). Consumers that can use the word-major
    order directly (BlockedELL's word-major operands) skip the
    interleave relayout entirely.
    """
    ctr_size = state.len_c
    wf = _words_generator(state)
    if wf is None or ctr_size != 4:
        return None
    ctr_mat_start, fbs, ctr_stride, nblk, _ = fill_geometry(
        n_cols_parent, n_scols, ptr, ctr_size)
    rows_gen = -(-n_srows // _ROW_ALIGN) * _ROW_ALIGN

    base = state.incr(ctr_mat_start)
    off_lo, off_hi = _row_block_offsets(rows_gen, nblk, ctr_stride)
    c0, c1, c2, c3 = ctr_add64_words(base.counter, off_lo, off_hi)
    xs = wf(c0, c1, c2, c3)                     # 4 planes (rows_gen, nblk)
    if transform == "boxmul":
        g0, g1 = boxmul_pair(xs[0], xs[1])
        g2, g3 = boxmul_pair(xs[2], xs[3])
        gs = (g0, g1, g2, g3)
    elif transform == "uneg11":
        gs = tuple(uneg11(x) for x in xs)
    else:
        raise ValueError(f"unknown transform {transform!r}")
    gs = tuple(jnp.broadcast_to(g, (rows_gen, nblk)) for g in gs)
    return gs, fbs, rows_gen, nblk


def fill_colmajor(
    n_cols_parent: int,
    n_srows: int,
    n_scols: int,
    ptr: int,
    state: RNGState,
    transform: str,
):
    """``fill_rowmajor(n_cols_parent, n_srows, n_scols, ptr, ...).T`` —
    bit-identical values, computed natively in the transposed orientation.

    ColMajor-natural fills generate the operator's transpose row-major and
    flip it, which made the generation itself run through a (n_srows,
    nblk, W) intermediate with a W=4 minor dim, which an accelerator
    lays out poorly when nblk is large. Here the four
    counter words stay separate 2-D (n_srows, nblk) planes end to end —
    counter limb math, generator rounds (word-wise forms shared with the
    Pallas kernels), float transform — and the output is assembled
    transposed: out[blk*W + w, row] = plane_w[row, blk]. The only data
    movement is W clean 2-D transposes; every plane is full-lane.
    """
    planes = fill_colmajor_planes(n_cols_parent, n_srows, n_scols, ptr,
                                  state, transform)
    if planes is None:
        return fill_rowmajor(n_cols_parent, n_srows, n_scols, ptr, state,
                             transform).T
    gs, fbs, rows_gen, nblk = planes
    out = jnp.stack([g.T for g in gs],
                    axis=1).reshape(nblk * 4, rows_gen)
    return out[fbs:fbs + n_scols, :n_srows]


def fill_rowmajor_traced_offset(
    n_cols_parent: int,
    n_srows: int,
    n_scols: int,
    row_off,
    col_off,
    state: RNGState,
    transform: str,
):
    """fill_rowmajor with *traced* submatrix offsets, for SPMD shards.

    The same (row, col) -> counter mapping, but the block position is a
    traced value (e.g. derived from jax.lax.axis_index inside shard_map),
    so every mesh shard generates its tile of the one global operator —
    bit-identical to the single-device fill. This is the reference's
    thread-count-invariance property promoted to mesh-shape invariance.

    Constraint: ``col_off`` must be a multiple of the counter width W
    (shards aligned to counter blocks — every natural-layout *row* is
    already counter-aligned thanks to the padding, so ``row_off`` is
    unconstrained). Callers are expected to size shards accordingly;
    this cannot be checked on traced values.
    """
    base = _traced_offset_base(n_cols_parent, n_scols, row_off, col_off,
                               state)
    return fill_rowmajor(n_cols_parent, n_srows, n_scols, 0, base,
                         transform)


def _traced_offset_base(n_cols_parent, n_scols, row_off, col_off,
                        state: RNGState) -> RNGState:
    """Base state with TRACED (row_off, col_off) submatrix offsets folded
    into the counter (col_off must be a multiple of the counter width).
    Shared by the row-major and word-plane traced fills."""
    ctr_size = state.len_c
    _, _, ctr_stride, _, _ = fill_geometry(n_cols_parent, n_scols, 0,
                                           ctr_size)
    row_off = jnp.asarray(row_off, dtype=jnp.uint32)
    col_off = jnp.asarray(col_off, dtype=jnp.uint32)
    lo, hi = mul64_u32(row_off, jnp.uint32(ctr_stride & 0xFFFFFFFF))
    stride_hi = (ctr_stride >> 32) & 0xFFFFFFFF
    if stride_hi:
        hi = hi + row_off * jnp.uint32(stride_hi)
    lo, hi = add64(lo, hi, col_off // jnp.uint32(ctr_size), jnp.uint32(0))
    return RNGState(ctr_add64(state.counter, lo, hi), state.key, state.rng)


def fill_colmajor_traced_offset(
    n_cols_parent: int,
    n_srows: int,
    n_scols: int,
    row_off,
    col_off,
    state: RNGState,
    transform: str,
):
    """``fill_rowmajor_traced_offset(...).T`` via the word-plane fill
    (same alignment contract: ``col_off`` a multiple of the counter
    width; ``row_off`` unconstrained)."""
    base = _traced_offset_base(n_cols_parent, n_scols, row_off, col_off,
                               state)
    return fill_colmajor(n_cols_parent, n_srows, n_scols, 0, base,
                         transform)


def fill_next_state(
    n_cols_parent: int, n_srows: int, n_scols: int, ptr: int,
    state: RNGState,
) -> RNGState:
    """State returned by a submatrix fill: seed advanced past the last row's
    first counter (dense_skops.hh:166-169). Pure counter arithmetic.
    ``block_width`` (counter WORDS) keeps the same geometry for x64
    states, whose uint32 storage holds two limbs per word."""
    ctr_size = state.block_width
    ctr_mat_start, _, ctr_stride, _, _ = fill_geometry(
        n_cols_parent, n_scols, ptr, ctr_size)
    return state.incr(ctr_mat_start).incr(n_srows * ctr_stride)
