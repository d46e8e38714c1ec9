"""RNG-in-GEMM dense sketch: one Pallas kernel on the GPU's Triton route.

Computes B = alpha * G @ A where G is an implicit (d, m) Gaussian or
uniform operator block: its tiles are generated from Philox/Threefry
counters in registers and fed straight to the tensor cores, so the
operator never exists in device memory (the fused form of the
reference's lazy lskge3 path, skge.hh:174-215 + the dense_skops.hh fill).

One kernel serves both counter orientations of ``fill_dense_submat``:

- ``stride_axis=0`` (natural RowMajor): element (i, c) lives at counter
  ``seed + i*ctr_stride + c//4``, lane ``c % 4``;
- ``stride_axis=1`` (natural ColMajor): element (i, c) lives at counter
  ``seed + c*ctr_stride + i//4``, lane ``i % 4``.

Each program owns one (ti, tn) output tile and one split of the
contraction, and walks that split in tk-wide steps: generate the (ti, tk)
operator panel as four counter-lane planes, then contract each plane with
the matching rows of A (``pl.dot`` at the default f32 precision, which is
TF32 on Hopper — the same precision XLA's default f32 GEMM uses on the
staged path). Split partials are summed outside the kernel.

Lane planes need no in-kernel interleave: in RowMajor, lane l's plane
multiplies rows ``4b + l`` of A, which are columns ``[l*n, (l+1)*n)`` of
the free view ``A.reshape(m/4, 4n)``; in ColMajor, lane l's plane produces
output rows ``4b + l``, which are columns ``[l*n, (l+1)*n)`` of the free
view ``B.reshape(d/4, 4n)``.

Every operator element is regenerated once per output column tile, so
the kernel pays only where one tile covers all of n (``fused_profitable``;
the measurements behind it are in PERF.md).

Stream identity: uint32 words match ``fill_dense_submat`` bit for bit;
float values go through the same transforms (rng/transforms.py), evaluated
by Triton's libdevice instead of XLA's, so Gaussians agree to ~1 ulp.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..rng.bits import mul32_wide
from ..rng.philox import philox4x32_words
from ..rng.transforms import boxmul_pair_i32, uneg11_i32

_SQRT3 = math.sqrt(3.0)
_SUPPORTED_RNGS = ("philox4x32", "threefry4x32")

# The "auto" dispatch rule, from same-call H100 measurements against the
# staged fill + GEMM (PERF.md, "RNG-in-GEMM kernel"): with one column
# tile (n <= 128) the kernel won at every measured shape, 1.07x at
# (d, m) = (1024, 2^18) up to 1.47x at (1024, 2^20) with n = 64; at
# n = 256 it lost (0.61x) and at the headline n = 4096 it lost 7x.
# Shorter contractions than 2^18 were not measured and stay staged.
FUSED_MAX_N = 128
FUSED_MIN_M = 1 << 18

# Triton launch options and tiles: (ti, tk) per stride_axis (operator
# rows per program, contraction columns per step) and the widest tn.
# Small tiles keep the Philox state of a step in registers; measured on
# the H100 at d=1024, m=2^20, n=128 (PERF.md): ti=16/tk=64 beat 32 and 64
# rows, and splitting the contraction into ~2112 programs (16 per SM)
# beat 264, 528 and 1056.
_NUM_WARPS = 4
_NUM_STAGES = 2
TILES = {0: (16, 64), 1: (64, 32)}
_TN = 128
_TARGET_PROGRAMS = 2112


def _gen_panel_words(seed, d: int, tk: int, ctr_stride: int, k_blocks,
                     gaussian: bool, row_off=0, rng: str = "philox4x32",
                     stride_axis: int = 0):
    """Generate one operator panel as four counter-lane planes.

    ``seed`` holds the eight uint32 scalars of ``_seed_words`` (four
    counter words, then the key). Counter of plane element (r, b):
    ``seed + (row_off + i) * ctr_stride + k_blocks + b'``, where the
    stride index i walks array axis ``stride_axis`` and the block index
    b' walks the other axis:

    - 0: planes are (d, tk/4); word l of element (i, b) is operator
      element (row_off + i, 4(k_blocks + b) + l);
    - 1: planes are (d, tk); word l of element (b, c) is operator element
      (4(k_blocks + b) + l, row_off + c).
    """
    nb = tk // 4 if stride_axis == 0 else tk
    shape = (d, nb)
    i_ids = jax.lax.broadcasted_iota(jnp.uint32, shape, stride_axis)
    i_ids = i_ids + jnp.asarray(row_off, dtype=jnp.uint32)
    b_ids = jax.lax.broadcasted_iota(jnp.uint32, shape, 1 - stride_axis)

    off_hi, off_lo = mul32_wide(i_ids, jnp.uint32(ctr_stride & 0xFFFFFFFF))
    stride_hi = (ctr_stride >> 32) & 0xFFFFFFFF
    if stride_hi:
        off_hi = off_hi + i_ids * jnp.uint32(stride_hi)
    kb = jnp.asarray(k_blocks, dtype=jnp.uint32)
    t = off_lo + kb
    off_hi = off_hi + (t < kb).astype(jnp.uint32)
    off_lo = t + b_ids
    off_hi = off_hi + (off_lo < b_ids).astype(jnp.uint32)

    c0 = seed[0] + off_lo
    carry = (c0 < off_lo).astype(jnp.uint32)
    t1 = seed[1] + off_hi
    ca = (t1 < off_hi).astype(jnp.uint32)
    c1 = t1 + carry
    cb = (c1 < carry).astype(jnp.uint32)
    carry1 = ca | cb
    c2 = seed[2] + carry1
    carry2 = (c2 < carry1).astype(jnp.uint32)
    c3 = seed[3] + carry2

    if rng == "philox4x32":
        words = philox4x32_words(c0, c1, c2, c3, seed[4], seed[5], 10)
    elif rng == "threefry4x32":
        from ..rng.threefry import threefry4x32_words
        words = threefry4x32_words(c0, c1, c2, c3, seed[4], seed[5],
                                   seed[6], seed[7], 20)
    else:
        raise NotImplementedError(f"fused kernel: unsupported rng {rng}")
    s0, s1, s2, s3 = (jax.lax.bitcast_convert_type(w, jnp.int32)
                      for w in words)
    if gaussian:
        v0, v1 = boxmul_pair_i32(s0, s1)
        v2, v3 = boxmul_pair_i32(s2, s3)
        return v0, v1, v2, v3
    sqrt3 = jnp.float32(_SQRT3)
    return tuple(uneg11_i32(s) * sqrt3 for s in (s0, s1, s2, s3))


def _kernel(seed_ref, a_ref, o_ref, *, ti, tk, tn, n_steps, d_rows,
            n_cols, ctr_stride, gaussian, rng, stride_axis):
    """Program (i, j, s): output tile i (ti operator rows) x j (tn data
    columns), contraction split s (n_steps steps of tk columns)."""
    i = pl.program_id(0)
    j = pl.program_id(1)
    s = pl.program_id(2)
    seed = tuple(seed_ref[w] for w in range(8))
    c0 = j * tn
    dt = a_ref.dtype

    if stride_axis == 0:
        nb = tk // 4
        row_off = (i * ti).astype(jnp.uint32)

        def body(kk, acc):
            k = s * n_steps + kk
            planes = _gen_panel_words(seed, ti, tk, ctr_stride,
                                      k.astype(jnp.uint32) * jnp.uint32(nb),
                                      gaussian, row_off, rng, 0)
            for lane, v in enumerate(planes):
                a_l = a_ref[pl.ds(k * nb, nb), pl.ds(lane * n_cols + c0, tn)]
                acc = acc + pl.dot(v.astype(dt), a_l)
            return acc

        acc = jax.lax.fori_loop(0, n_steps, body,
                                jnp.zeros((ti, tn), jnp.float32))
        o_ref[pl.ds(s * d_rows + i * ti, ti), pl.ds(c0, tn)] = acc
        return

    tq = ti // 4
    blk_off = (i * tq).astype(jnp.uint32)

    def body_t(kk, accs):
        k = s * n_steps + kk
        planes = _gen_panel_words(seed, tq, tk, ctr_stride, blk_off,
                                  gaussian, (k * tk).astype(jnp.uint32),
                                  rng, 1)
        a_k = a_ref[pl.ds(k * tk, tk), pl.ds(c0, tn)]
        return tuple(acc + pl.dot(v.astype(dt), a_k)
                     for acc, v in zip(accs, planes))

    zero = jnp.zeros((tq, tn), jnp.float32)
    accs = jax.lax.fori_loop(0, n_steps, body_t, (zero,) * 4)
    rows = pl.ds(s * (d_rows // 4) + i * tq, tq)
    for lane, acc in enumerate(accs):
        o_ref[rows, pl.ds(lane * n_cols + c0, tn)] = acc


def _pow2_at_least(x: int, lo: int, hi: int) -> int:
    p = lo
    while p < x and p < hi:
        p *= 2
    return p


def _plan(d: int, m: int, n: int, stride_axis: int):
    """(d_pad, m_pad, n_pad, ti, tk, tn, splits, n_steps) for a (d, m) x
    (m, n) product. Triton tiles are powers of two and every dot
    dimension is at least 16; d, m and n pad up to whole tiles (phantom
    operator rows are sliced off, phantom columns multiply zero data)."""
    tn = _pow2_at_least(n, 16, _TN)
    ti_max, tk = TILES[stride_axis]
    # a plane has ti rows (RowMajor) or ti/4 rows (ColMajor): >= 16
    ti = _pow2_at_least(d, 16 if stride_axis == 0 else 64, ti_max)
    d_pad = -(-d // ti) * ti
    n_pad = -(-n // tn) * tn
    steps = -(-m // tk)
    tiles = (d_pad // ti) * (n_pad // tn)
    splits = max(1, min(steps, -(-_TARGET_PROGRAMS // tiles)))
    n_steps = -(-steps // splits)
    splits = -(-steps // n_steps)
    m_pad = splits * n_steps * tk
    return d_pad, m_pad, n_pad, ti, tk, tn, splits, n_steps


def _call(seed_words, a, *, d, gaussian, ctr_stride, stride_axis, rng,
          interpret):
    """G @ a for the (d, m) counter map G; a is (m, n), f32 or bf16.
    Returns f32 (d, n)."""
    m, n = a.shape
    d_pad, m_pad, n_pad, ti, tk, tn, splits, n_steps = _plan(
        d, m, n, stride_axis)
    if m_pad != m or n_pad != n:
        a = jnp.pad(a, ((0, m_pad - m), (0, n_pad - n)))
    if stride_axis == 0:
        a_in = a.reshape(m_pad // 4, 4 * n_pad)
        out_shape = (splits * d_pad, n_pad)
    else:
        a_in = a
        out_shape = (splits * d_pad // 4, 4 * n_pad)
    kernel = functools.partial(
        _kernel, ti=ti, tk=tk, tn=tn, n_steps=n_steps, d_rows=d_pad,
        n_cols=n_pad, ctr_stride=ctr_stride, gaussian=gaussian, rng=rng,
        stride_axis=stride_axis)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        grid=(d_pad // ti, n_pad // tn, splits),
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=_NUM_STAGES),
        name="rng_in_gemm_sketch",
    )(seed_words, a_in)
    out = out.reshape(splits, d_pad * n_pad).sum(axis=0)
    out = out.reshape(d_pad, n_pad)
    return out[:d, :n]


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4, 5, 6, 7))
def fused_call(seed_words, a, d, gaussian, ctr_stride, stride_axis, rng,
               interpret):
    """G @ a (f32) for the (d, a.shape[0]) counter map G with base counter
    ``seed_words`` and counter stride ``ctr_stride`` (see the module
    docstring for the two orientations), differentiable in a.

    The entry point for callers that fold their own, possibly traced,
    submatrix offsets into ``seed_words`` (the distributed shard bodies).
    The cotangent G^T @ g is the same kernel in the other orientation with
    the same seed and stride: G^T(i, c) = G(c, i)."""
    return _call(seed_words, a, d=d, gaussian=gaussian,
                 ctr_stride=ctr_stride, stride_axis=stride_axis, rng=rng,
                 interpret=interpret)


def _fused_call_fwd(seed_words, a, d, gaussian, ctr_stride, stride_axis,
                    rng, interpret):
    out = fused_call(seed_words, a, d, gaussian, ctr_stride, stride_axis,
                     rng, interpret)
    return out, (seed_words, jnp.zeros((0, a.shape[0]), a.dtype))


def _fused_call_bwd(d, gaussian, ctr_stride, stride_axis, rng, interpret,
                    res, g):
    import numpy as np
    seed_words, a_tok = res
    da = _call(seed_words, g.astype(a_tok.dtype), d=a_tok.shape[1],
               gaussian=gaussian, ctr_stride=ctr_stride,
               stride_axis=1 - stride_axis, rng=rng, interpret=interpret)
    return (np.zeros(seed_words.shape, jax.dtypes.float0),
            da.astype(a_tok.dtype))


fused_call.defvjp(_fused_call_fwd, _fused_call_bwd)


def seed_words(counter, key) -> jax.Array:
    """(8,) uint32 kernel seed: four counter words, then the key (two
    words for Philox, four for Threefry), zero-padded. Works on traced
    counter/key arrays."""
    parts = [counter, key]
    pad = 8 - counter.shape[0] - key.shape[0]
    if pad:
        parts.append(jnp.zeros((pad,), jnp.uint32))
    return jnp.concatenate(parts)


def fused_sketch_supported(dist, rows_s: int, cols_s: int, ro_s: int,
                           co_s: int, dtype, rng: str) -> bool:
    """Whether the kernel can compute submat(S) @ A for this block: a
    Gaussian or uniform operator on a 4x32 counter-based generator, f32
    or bf16 data, block inside the operator. Any offset works: an
    unaligned offset along the counter-lane axis is reduced to the
    aligned case by padding (see fused_sketch)."""
    from ..dense import DenseDistName
    return (jnp.dtype(dtype) in (jnp.dtype(jnp.float32),
                                 jnp.dtype(jnp.bfloat16))
            and dist.family in (DenseDistName.Gaussian,
                                DenseDistName.Uniform)
            and rng in _SUPPORTED_RNGS
            and rows_s + ro_s <= dist.n_rows
            and cols_s + co_s <= dist.n_cols)


def fused_profitable(d: int, m: int, n: int) -> bool:
    """The H100 dispatch rule for a (d, m) x (m, n) sketch: the kernel
    only where one output column tile covers n and the contraction is
    long enough that the staged operator would be large."""
    del d
    return n <= FUSED_MAX_N and m >= FUSED_MIN_M


def fused_sketch(S, A, alpha=1.0, interpret=False, rows_s=None,
                 cols_s=None, ro_s=0, co_s=0):
    """B = alpha * submat(S) @ A with the operator block generated inside
    the kernel, for either natural layout of S.

    The block is bit-identical (at the uint32 level) to slicing the full
    operator: the counter stride always comes from the true parent
    extent along the counter-lane axis, and the block's base counter
    folds into the kernel seed. An offset that is not a multiple of the
    counter width along that axis starts generation at the previous lane
    boundary: RowMajor pads A with that many zero rows on top (the extra
    operator columns multiply zeros); ColMajor generates the extra
    operator rows and slices them off.

    bf16 data stays bf16 on the tensor cores (f32 accumulation) and the
    result is bf16; f32 data runs at TF32 and the result is f32.
    Differentiable in A (see fused_call). ``interpret`` runs the Pallas
    interpreter (CPU tests).
    """
    from ..base import Layout
    from ..dense import DenseDistName, dist_to_layout

    dist, state = S.dist, S.seed_state
    rows_s = dist.n_rows if rows_s is None else int(rows_s)
    cols_s = dist.n_cols if cols_s is None else int(cols_s)
    A = jnp.asarray(A)
    if A.dtype != jnp.bfloat16:
        A = A.astype(jnp.float32)
    gaussian = dist.family == DenseDistName.Gaussian
    if dist_to_layout(dist) == Layout.RowMajor:
        ctr_stride = -(-dist.n_cols // 4)
        fbs = co_s % 4
        if fbs:
            A = jnp.pad(A, ((fbs, 0), (0, 0)))
        base = state.incr(ro_s * ctr_stride + (co_s - fbs) // 4)
        out = fused_call(seed_words(base.counter, base.key), A, rows_s,
                         gaussian, ctr_stride, 0, state.rng,
                         bool(interpret))
    else:
        ctr_stride = -(-dist.n_rows // 4)
        fbs = ro_s % 4
        base = state.incr(co_s * ctr_stride + (ro_s - fbs) // 4)
        out = fused_call(seed_words(base.counter, base.key), A,
                         rows_s + fbs, gaussian, ctr_stride, 1, state.rng,
                         bool(interpret))
        out = out[fbs:]
    out = jnp.asarray(alpha, jnp.float32) * out
    return out.astype(A.dtype)
