"""High-precision (f64) GEMM from int8 matrix products via integer slicing.

For accelerators whose f64 matmul rate is far below their int8 rate. The
reference library is templated over T in {float, double} and its
headline TLS config is fp64 (RandBLAS/skge.hh:174-364; BASELINE.md
config 1). The H100 has native f64 tensor cores, so the library's
default is the native f64 matmul and this path runs only when forced
(skge.use_hiprec_f64 = True).

This module implements an Ozaki-style error-free slicing scheme:

  1. Each operand row (of A) / column (of B) is scaled by a power of two
     so its magnitude is < 2^(q-1), then peeled into S integer slices of
     q bits each:  R_0 = A*sigma;  a_t = round(R_t);  R_{t+1} = (R_t -
     a_t) * 2^q.  Every step is EXACT in floating point (the residual is
     the low-order mantissa bits), |a_t| <= 2^(q-1) fits int8.
  2. Each slice-pair product a_t @ b_u runs as an int8 x int8 -> int32
     contraction. With q = 7, |products| <= 2^12, so int32
     accumulation is exact for contraction lengths up to 2^18 — the
     matmul itself introduces NO rounding error.
  3. Slice products are recombined exactly: each int32 panel splits into
     (hi << 16) + lo halves, same-level panels sum in int32 (still
     exact), and only the final weighted sum of ~9 level values runs in
     f64 — O(mn) work vs the O(mnk) in int8.

Accuracy: slices cover q*S bits of each operand's significand and levels
t+u <= cutoff contribute down to 2^(-q*cutoff) relative; with the f64
defaults (S=8, cutoff=8) the result matches a true f64 GEMM to ~1 ulp of
the f64 rounding of the final level sum. NOTE f32-exact operands (e.g.
dense sketching operators, whose values the reference also generates in
f32 and promotes — dense_skops.hh:50-55) still need the full 8 slices:
slice levels align to the ROW max, so a small-magnitude entry's 24
mantissa bits extend into slices 4..7 (a 4-slice attempt measurably
lost 8 digits; see skge._matmul).

Not supported: Inf/NaN entries (like every slicing scheme); row/column
maxima outside float32's exponent range (~2^-126 .. 2^127) — the
power-of-two scaling extracts exponents through an f32 frexp, which
needs no 64-bit integer bitcast.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_Q = 7  # bits per slice; |slice| <= 2^(q-1) = 64, product <= 2^12


def _slices_for_dtype(dtype) -> int:
    # ceil(significand bits / q): f64 -> 8 covers 56 bits, f32 -> 4 (28)
    return 8 if jnp.dtype(dtype) == jnp.float64 else 4


def _f32_parts(x):
    """x as a list of (f32 part, level offset): x ~ sum_p part * 2^(-q*lvl)
    ... no — parts sum directly: x ~ hi + mid + lo, each exactly f32.

    Why parts: where f64 is EMULATED as an (hi, lo) float32 pair with
    non-IEEE rounding, residual peeling in 'f64' arithmetic silently
    loses exactness. Extracting the f32 parts first is exact under both
    real f64 and such a double-float emulation, and
    every subsequent slicing step runs in native, exactly-rounded f32.
    """
    if jnp.dtype(x.dtype) != jnp.float64:
        return [jnp.asarray(x, jnp.float32)]
    hi = x.astype(jnp.float32)
    r = x - hi.astype(x.dtype)
    mid = r.astype(jnp.float32)
    lo = (r - mid.astype(x.dtype)).astype(jnp.float32)
    return [hi, mid, lo]


def _axis_scale(x, axis: int):
    """Power-of-two grid scale per row (axis=1) / column (axis=0):
    scale = 2^(q-2-e) with the axis max < 2^e. q-2 (not q-1) absorbs the
    f32 rounding of the max (the true f64 max can exceed the f32 part's
    max by one ulp) while keeping every slice within int8. Exponents must
    lie in f32 range (~2^-126 .. 2^127), documented above."""
    q = _Q
    hi = x.astype(jnp.float32) if jnp.dtype(x.dtype) == jnp.float64 else x
    mx = jnp.max(jnp.abs(hi), axis=axis, keepdims=True)
    _, e = jnp.frexp(mx)
    scale = jnp.ldexp(jnp.float32(1.0), (q - 2) - e)
    return jnp.where(mx > 0, scale, jnp.float32(1.0))


def _slice_operand(x, n_slices: int, axis: int, scale=None):
    """Peel `x` into int8 slices along with its power-of-two scale.

    Returns (slices int8[n_slices, *x.shape], scale f32[...]) where
    x == (sum_t slices[t] * 2^(-q*t)) / scale + residual, residual <
    ~2^(2-q*n_slices) relative to the axis max.

    All slice arithmetic is exact and runs in f32: x splits into f32
    parts (hi + mid + lo for f64), each part peels on the SHARED
    per-row/col power-of-two grid starting at the level where its
    magnitude bound lands (hi: 0, mid: 3, lo: 6 — a part is at most
    2^-24 of its predecessor and 3 levels = 21 bits), and same-level
    slices add (bounded by 64 + 8 + 8, still int8).
    """
    q = _Q
    parts = _f32_parts(x)
    if scale is None:
        scale = _axis_scale(x, axis)
    two_q = jnp.float32(2.0 ** q)
    levels = [None] * n_slices
    for p, lvl0 in zip(parts, (0, 3, 6)):
        if lvl0 >= n_slices:
            break
        # bring the part onto the shared grid at its start level; the
        # 2^(q*lvl0) step is exact (powers of two, no overflow: |p *
        # scale| < 2^(q-2) * 2^(-7*lvl0+2))
        r = p * scale
        for _ in range(lvl0):
            r = r * two_q
        for t in range(lvl0, n_slices):
            s = jnp.round(r)
            si = s.astype(jnp.int16)
            levels[t] = si if levels[t] is None else levels[t] + si
            r = (r - s) * two_q
    # carry pass: summed levels can reach |129| (64 + 64 + 1, two parts
    # overlapping plus a start slice); move multiples of 128 = 2^q one
    # level up (exactly 1 unit there) so every slice fits int8.
    zero = jnp.zeros(x.shape, jnp.int16)
    levels = [zero if l is None else l for l in levels]
    for t in range(n_slices - 1, 0, -1):
        c = (levels[t] + jnp.int16(64)) >> 7  # floor((v+64)/128)
        levels[t] = levels[t] - (c << 7)
        levels[t - 1] = levels[t - 1] + c
    return jnp.stack([l.astype(jnp.int8) for l in levels]), scale


def _level_products(a_sl, b_sl, sa: int, sb: int, cutoff: int,
                    ta: bool = False):
    """int8 x int8 -> int32 slice products grouped by level t+u, each
    level split into exact (hi << 16) + lo int32 halves.

    Returns (hi_stack, lo_stack), both int32[cutoff+1, m, n]. The split
    keeps cross-k-block accumulation exact in int32: lo halves are in
    [0, 65535] and hi halves < 2^13 per block, so sums stay well inside
    int32 for thousands of blocks. ta=True contracts a's dim 0 instead
    (a stored (k, m) — a TN GEMM)."""
    n_lvl = cutoff + 1
    m = a_sl.shape[2] if ta else a_sl.shape[1]
    n = b_sl.shape[2]
    dims = (((0,), (0,)), ((), ())) if ta else (((1,), (0,)), ((), ()))
    zero = jnp.zeros((m, n), jnp.int32)
    levels_hi = [zero] * n_lvl
    levels_lo = [zero] * n_lvl
    for t in range(sa):
        for u in range(sb):
            lvl = t + u
            if lvl > cutoff:
                continue
            d = jax.lax.dot_general(
                a_sl[t], b_sl[u], dims,
                preferred_element_type=jnp.int32)
            hi = jax.lax.shift_right_arithmetic(d, jnp.int32(16))
            lo = jax.lax.bitwise_and(d, jnp.int32(0xFFFF))
            levels_hi[lvl] = levels_hi[lvl] + hi
            levels_lo[lvl] = levels_lo[lvl] + lo
    return jnp.stack(levels_hi), jnp.stack(levels_lo)


def _combine_levels(hi_stack, lo_stack, a_scale, b_scale):
    """The only f64 arithmetic: the ~9-term weighted level sum, highest
    level first, then the exact power-of-two unscaling."""
    out = jnp.zeros(hi_stack.shape[1:], jnp.float64)
    for lvl in range(hi_stack.shape[0] - 1, -1, -1):
        w = jnp.float64(2.0 ** (-_Q * lvl))
        out = out + w * (hi_stack[lvl].astype(jnp.float64) * 65536.0
                         + lo_stack[lvl].astype(jnp.float64))
    return out / (a_scale.astype(jnp.float64)
                  * b_scale.astype(jnp.float64))


@functools.partial(jax.jit, static_argnames=("sa", "sb", "cutoff", "ta"))
def _recombine(a_sl, a_scale, b_sl, b_scale, sa: int, sb: int,
               cutoff: int, ta: bool = False):
    hi, lo = _level_products(a_sl, b_sl, sa, sb, cutoff, ta)
    return _combine_levels(hi, lo, a_scale, b_scale)


# contraction lengths above this are processed in blocks so the int8
# slice copies of both operands never exceed ~operand-size peak memory
_K_BLOCK = 16384


def matmul_hiprec(a, b, *, slices_a: int = None, slices_b: int = None,
                  cutoff: int = None, k_block: int = None,
                  transpose_a: bool = False):
    """a @ b at (near-)f64 accuracy with all O(mnk) work in int8 GEMMs.

    a: (m, k), b: (k, n); float32 or float64 (slices per operand default
    from its dtype: f64 -> 8, f32 -> 4). Returns float64 (requires
    jax_enable_x64). cutoff: highest slice level t+u kept; defaults to
    the maximum useful level min(sa + sb - 2, ceil(60 / q)). Contractions
    longer than k_block (default 16384) are blocked over k — slices of
    one block live at a time, level partial sums accumulate exactly in
    int32 (valid to ~32k blocks = k ~ 5e8).

    transpose_a=True takes a stored as (k, m) and computes a.T @ b
    without ever materializing the transpose: the int8 dots contract
    a's dim 0 (a TN GEMM). Used by the staged
    sketching path to consume natural-orientation operator fills whose
    transposed materialization would be a slow unaligned relayout.
    """
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"bad shapes {a.shape} x {b.shape}")
    a_k_dim, a_m_dim = (0, 1) if transpose_a else (1, 0)
    if a.shape[a_k_dim] != b.shape[0]:
        raise ValueError(f"bad shapes {a.shape} x {b.shape}"
                         f" (transpose_a={transpose_a})")
    sa = _slices_for_dtype(a.dtype) if slices_a is None else slices_a
    sb = _slices_for_dtype(b.dtype) if slices_b is None else slices_b
    if cutoff is None:
        cutoff = min(sa + sb - 2, -(-60 // _Q))
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    # pad every dimension to a tile-friendly multiple: zero rows/columns
    # are EXACT under the slicing scheme (a zero row's axis max is 0 ->
    # scale 1, all its slices are 0, and zero int8 products contribute
    # nothing), and odd shapes starve int8 matrix units.
    m_true = a.shape[a_m_dim]
    k_true = a.shape[a_k_dim]
    n_true = b.shape[1]
    kb = _K_BLOCK if k_block is None else k_block
    mp = -(-m_true // 128) * 128
    np_ = -(-n_true // 128) * 128
    # k padding: only when the whole contraction fits one block. On the
    # blocked path the full kb blocks are already 128-aligned (kb is a
    # multiple of 128) and only the TAIL block gets padded below — padding
    # k here would copy both (possibly multi-GB) operands in full, the
    # exact cost the tail-block design exists to avoid.
    kp = -(-k_true // 128) * 128 if k_true <= kb else k_true
    if mp != m_true or kp != k_true:
        pads = (((0, kp - k_true), (0, mp - m_true)) if transpose_a
                else ((0, mp - m_true), (0, kp - k_true)))
        a = jnp.pad(a, pads)
    if np_ != n_true or kp != k_true:
        b = jnp.pad(b, ((0, kp - k_true), (0, np_ - n_true)))
    k = a.shape[a_k_dim]
    scale_axis_a = a_k_dim  # reduce over k: per-output-row maxima

    def unpad(out):
        return (out[:m_true, :n_true]
                if (mp != m_true or np_ != n_true) else out)

    if k <= kb:
        a_sl, a_scale = _slice_operand(a, sa, axis=scale_axis_a)
        b_sl, b_scale = _slice_operand(b, sb, axis=0)
        a_scale = a_scale.T if transpose_a else a_scale
        return unpad(_recombine(a_sl, a_scale, b_sl, b_scale, sa, sb,
                                cutoff, transpose_a))

    # blocked path: the slicing grid comes from the FULL-axis max so all
    # blocks share it. The tail (k % kb) is processed separately rather
    # than zero-padding, which would copy both multi-GB operands.
    a_scale = _axis_scale(a, scale_axis_a)
    b_scale = _axis_scale(b, 0)
    n_full = k // kb
    tail = k - n_full * kb

    def block_products(a_blk, b_blk):
        a_sl, _ = _slice_operand(a_blk, sa, axis=scale_axis_a,
                                 scale=a_scale)
        b_sl, _ = _slice_operand(b_blk, sb, axis=0, scale=b_scale)
        return _level_products(a_sl, b_sl, sa, sb, cutoff, transpose_a)

    def step(carry, i):
        hi_acc, lo_acc = carry
        a_blk = jax.lax.dynamic_slice_in_dim(a, i * kb, kb, a_k_dim)
        b_blk = jax.lax.dynamic_slice_in_dim(b, i * kb, kb, 0)
        hi, lo = block_products(a_blk, b_blk)
        return (hi_acc + hi, lo_acc + lo), None

    m, n = a.shape[a_m_dim], b.shape[1]
    zeros = jnp.zeros((cutoff + 1, m, n), jnp.int32)
    hi, lo = zeros, zeros
    if n_full:
        (hi, lo), _ = jax.lax.scan(step, (hi, lo), jnp.arange(n_full))
    if tail:
        a_tail = (a[n_full * kb:] if transpose_a else a[:, n_full * kb:])
        b_tail = b[n_full * kb:]
        tp = -(-tail // 128) * 128
        if tp != tail:
            # pad the TAIL block's k to a 128 multiple (zero k-rows are
            # exact under the slicing scheme) — tiny copies, vs padding
            # the whole contraction which would copy both operands
            a_tail = jnp.pad(a_tail, (((0, tp - tail), (0, 0))
                                      if transpose_a
                                      else ((0, 0), (0, tp - tail))))
            b_tail = jnp.pad(b_tail, ((0, tp - tail), (0, 0)))
        thi, tlo = block_products(a_tail, b_tail)
        hi, lo = hi + thi, lo + tlo
    out_scale_a = a_scale.T if transpose_a else a_scale
    return unpad(_combine_levels(hi, lo, out_scale_a, b_scale))
