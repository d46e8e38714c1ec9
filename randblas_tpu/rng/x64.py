"""Host-side 64-bit-counter CBRNGs and the native-f64 dense fill.

The reference's fill engine is templated over the CBRNG: instantiated
with a 64-bit-counter generator it produces NATIVE double streams — the
float width is deduced from the counter word size
(reference RandBLAS/random_gen.hh:121-173; fill engine
dense_skops.hh:97-170). They need 64-bit integer arithmetic, so this
framework keeps the x64 quartet (Philox2x64/4x64, Threefry2x64/4x64) on
the HOST: a vectorized numpy implementation here (always available) and
an independent OpenMP C++ one in native/randblas_host.cpp (KAT-verified
against the vendored Random123 vector file in tests/test_rng_kat.py).
The reference's x64 path is host code too — it has no device story at
all — so host-side f64 generation is full parity, not a compromise.

Counter/key REPRESENTATION: RNGState stores uint32 arrays. An x64
state's counter is the little-endian uint32 *limb* view of its uint64
words (word i -> limbs 2i (low), 2i+1 (high)). Because both the word
order and the intra-word limb order are little-endian, a base-2^32 add
with carries over the limb array (rng/bits.py::ctr_add64) is bitwise
the Random123 ``ctr.incr`` over the uint64 words — one `incr`
implementation serves both families.

Float transforms (Random123 uniform.hpp / boxmuller.hpp semantics, the
64-bit row of the same table the f32 path pins in rng/transforms.py):

    u01(u64)    = u * 2^-64 + 2^-65
    uneg11(u64) = (int64) u * 2^-63 + 2^-64
    boxmuller(u0, u1) = r*sin(pi*uneg11(u0)), r*cos(pi*uneg11(u0)),
                        r = sqrt(-2 log(u01(u1)))
"""

from __future__ import annotations

import math

import numpy as np

# ---------------------------------------------------------------------------
# uint64 block functions (vectorized over leading axes; all arithmetic
# wraps mod 2^64, numpy semantics)
# ---------------------------------------------------------------------------

_U64 = np.uint64
_M32 = _U64(0xFFFFFFFF)

_P2x64_M = _U64(0xD2B74407B1CE6E93)
_P64_W0 = _U64(0x9E3779B97F4A7C15)
_P64_W1 = _U64(0xBB67AE8584CAA73B)
_P4x64_M0 = _U64(0xD2E7470EE14C6C93)
_P4x64_M1 = _U64(0xCA5A826395121157)

_TF64_PARITY = _U64(0x1BD11BDAA9FC1A22)
_TF64_2_ROT = (16, 42, 12, 31, 16, 32, 24, 21)
_TF64_4_R0 = (14, 52, 23, 5, 25, 46, 58, 32)
_TF64_4_R1 = (16, 57, 40, 37, 33, 12, 22, 32)


def _mul64_wide(a, b):
    """Full 64x64 -> 128 multiply as (hi, lo) uint64 (schoolbook on
    32-bit halves; numpy has no uint128)."""
    a = a.astype(_U64)
    b = b.astype(_U64)
    al = a & _M32
    ah = a >> _U64(32)
    bl = b & _M32
    bh = b >> _U64(32)
    t = al * bl
    u = ah * bl + (t >> _U64(32))
    v = al * bh + (u & _M32)
    hi = ah * bh + (u >> _U64(32)) + (v >> _U64(32))
    lo = a * b
    return hi, lo


def _rotl64(x, r):
    r = _U64(r)
    return (x << r) | (x >> (_U64(64) - r))


def philox2x64(ctr, key, rounds: int = 10):
    """ctr: uint64[..., 2], key: uint64[..., 1] -> uint64[..., 2]."""
    ctr = np.asarray(ctr, _U64)
    key = np.asarray(key, _U64)
    x0, x1 = ctr[..., 0].copy(), ctr[..., 1].copy()
    k0 = np.broadcast_to(key[..., 0], x0.shape).copy()
    for r in range(rounds):
        if r > 0:
            k0 = k0 + _P64_W0
        hi, lo = _mul64_wide(_P2x64_M, x0)
        x0 = hi ^ k0 ^ x1
        x1 = lo
    return np.stack([x0, x1], axis=-1)


def philox4x64(ctr, key, rounds: int = 10):
    """ctr: uint64[..., 4], key: uint64[..., 2] -> uint64[..., 4]."""
    ctr = np.asarray(ctr, _U64)
    key = np.asarray(key, _U64)
    x0, x1 = ctr[..., 0].copy(), ctr[..., 1].copy()
    x2, x3 = ctr[..., 2].copy(), ctr[..., 3].copy()
    k0 = np.broadcast_to(key[..., 0], x0.shape).copy()
    k1 = np.broadcast_to(key[..., 1], x0.shape).copy()
    for r in range(rounds):
        if r > 0:
            k0 = k0 + _P64_W0
            k1 = k1 + _P64_W1
        hi0, lo0 = _mul64_wide(_P4x64_M0, x0)
        hi1, lo1 = _mul64_wide(_P4x64_M1, x2)
        x0 = hi1 ^ x1 ^ k0
        x1 = lo1
        x2 = hi0 ^ x3 ^ k1
        x3 = lo0
    return np.stack([x0, x1, x2, x3], axis=-1)


def threefry2x64(ctr, key, rounds: int = 20):
    """ctr: uint64[..., 2], key: uint64[..., 2] -> uint64[..., 2]."""
    ctr = np.asarray(ctr, _U64)
    key = np.asarray(key, _U64)
    ks = [key[..., 0], key[..., 1],
          _TF64_PARITY ^ key[..., 0] ^ key[..., 1]]
    x0 = ctr[..., 0] + ks[0]
    x1 = ctr[..., 1] + ks[1]
    for r in range(rounds):
        x0 = x0 + x1
        x1 = _rotl64(x1, _TF64_2_ROT[r % 8]) ^ x0
        if (r + 1) % 4 == 0:
            s = (r + 1) // 4
            x0 = x0 + ks[s % 3]
            x1 = x1 + ks[(s + 1) % 3] + _U64(s)
    return np.stack([x0, x1], axis=-1)


def threefry4x64(ctr, key, rounds: int = 20):
    """ctr: uint64[..., 4], key: uint64[..., 4] -> uint64[..., 4]."""
    ctr = np.asarray(ctr, _U64)
    key = np.asarray(key, _U64)
    ks = [key[..., i] for i in range(4)]
    ks.append(_TF64_PARITY ^ ks[0] ^ ks[1] ^ ks[2] ^ ks[3])
    x = [ctr[..., i] + ks[i] for i in range(4)]
    for r in range(rounds):
        r0, r1 = _TF64_4_R0[r % 8], _TF64_4_R1[r % 8]
        if r % 2 == 0:
            x[0] = x[0] + x[1]
            x[1] = _rotl64(x[1], r0) ^ x[0]
            x[2] = x[2] + x[3]
            x[3] = _rotl64(x[3], r1) ^ x[2]
        else:
            x[0] = x[0] + x[3]
            x[3] = _rotl64(x[3], r0) ^ x[0]
            x[2] = x[2] + x[1]
            x[1] = _rotl64(x[1], r1) ^ x[2]
        if (r + 1) % 4 == 0:
            s = (r + 1) // 4
            for i in range(4):
                x[i] = x[i] + ks[(s + i) % 5]
            x[3] = x[3] + _U64(s)
    return np.stack(x, axis=-1)


# name -> (block fn, ctr words, key words, rounds)
GENERATORS_X64 = {
    "philox2x64": (philox2x64, 2, 1, 10),
    "philox4x64": (philox4x64, 4, 2, 10),
    "threefry2x64": (threefry2x64, 2, 2, 20),
    "threefry4x64": (threefry4x64, 4, 4, 20),
}


# ---------------------------------------------------------------------------
# limb <-> word views (RNGState stores uint32 limbs)
# ---------------------------------------------------------------------------

def limbs_to_words(limbs) -> np.ndarray:
    """uint32[2w] little-endian limbs -> uint64[w] words."""
    limbs = np.asarray(limbs, np.uint32).astype(_U64)
    lo = limbs[..., 0::2]
    hi = limbs[..., 1::2]
    return lo | (hi << _U64(32))


def words_to_limbs(words) -> np.ndarray:
    """uint64[w] words -> uint32[2w] little-endian limbs."""
    words = np.asarray(words, _U64)
    out = np.empty(words.shape[:-1] + (2 * words.shape[-1],), np.uint32)
    out[..., 0::2] = (words & _M32).astype(np.uint32)
    out[..., 1::2] = (words >> _U64(32)).astype(np.uint32)
    return out


# ---------------------------------------------------------------------------
# double transforms
# ---------------------------------------------------------------------------

def u01_f64(u) -> np.ndarray:
    return np.asarray(u, _U64).astype(np.float64) * 2.0 ** -64 + 2.0 ** -65


def uneg11_f64(u) -> np.ndarray:
    return (np.asarray(u, _U64).astype(np.int64).astype(np.float64)
            * 2.0 ** -63 + 2.0 ** -64)


def block_values_f64(blocks: np.ndarray, transform: str) -> np.ndarray:
    """uint64[..., w] raw blocks -> float64[..., w] values.

    'uneg11' maps each word; 'boxmul' maps word pairs (2i, 2i+1) to
    (r sin, r cos) exactly as r123ext::boxmulall does for x64 counters
    (random_gen.hh:81-110: pairwise over the block, width deduced from
    the counter element size).
    """
    if transform == "uneg11":
        return uneg11_f64(blocks)
    if transform != "boxmul":
        raise ValueError(f"unknown transform {transform!r}")
    u0 = blocks[..., 0::2]
    u1 = blocks[..., 1::2]
    ang = np.pi * uneg11_f64(u0)
    r = np.sqrt(-2.0 * np.log(u01_f64(u1)))
    out = np.empty(blocks.shape, np.float64)
    out[..., 0::2] = np.sin(ang) * r
    out[..., 1::2] = np.cos(ang) * r
    return out


# ---------------------------------------------------------------------------
# counter-addressed f64 fill (host)
# ---------------------------------------------------------------------------

def _ctr_offsets(words: np.ndarray, n) -> np.ndarray:
    """words (w,) uint64 + integer offsets n (any shape, python-int-safe)
    -> (..., w) counters, with multiword little-endian carries. Offsets
    are < 2^63 in practice (they are element counts)."""
    n = np.asarray(n, _U64)
    out = np.broadcast_to(words, n.shape + words.shape).copy()
    lo = out[..., 0] + n
    carry = (lo < n).astype(_U64)
    out[..., 0] = lo
    for i in range(1, words.shape[-1]):
        s = out[..., i] + carry
        carry = (s < carry).astype(_U64)
        out[..., i] = s
        if not carry.any():
            break
    return out


def fill_rowmajor64(n_cols_parent: int, n_srows: int, n_scols: int,
                    ptr: int, state, transform: str) -> np.ndarray:
    """Native-f64 counter-addressed row-major submatrix fill.

    Mirrors ops/dense_fill.py::fill_rowmajor (and the reference's
    fill_dense_submat_impl, dense_skops.hh:97-170) with the x64 CBRNG
    named by ``state.rng``: element (r, c) of the submatrix reads lane
    (fbs + c) % w of counter base + ctr_mat_start + r*stride +
    (fbs + c)//w, where w is the counter width in WORDS (4 for the 4x64
    generators — the same padding math as x32, so submatrix/next_state
    semantics are identical across widths).

    ``state`` is an x64 RNGState (uint32 limb storage). Returns a
    float64 numpy array; 'uneg11' values are UNSCALED (callers apply
    sqrt(3) for the Uniform family, matching dense.py).
    """
    fn, w, _, rounds = GENERATORS_X64[state.rng]
    ctr_words = limbs_to_words(np.asarray(state.counter))
    key_words = limbs_to_words(np.asarray(state.key))

    pad = (-n_cols_parent) % w
    ptr_padded = ptr + (ptr // n_cols_parent) * pad
    ctr_mat_start = ptr_padded // w
    fbs = ptr_padded % w
    stride = (n_cols_parent + pad) // w
    nblk = (fbs + n_scols - 1) // w + 1

    # (n_srows, nblk) block offsets -> counters -> raw blocks -> values
    offs = (ctr_mat_start
            + np.arange(n_srows, dtype=np.uint64)[:, None] * np.uint64(stride)
            + np.arange(nblk, dtype=np.uint64)[None, :])
    ctrs = _ctr_offsets(ctr_words, offs)              # (R, B, w)
    vals = block_values_f64(fn(ctrs, key_words, rounds), transform)
    flat = vals.reshape(n_srows, nblk * w)
    return np.ascontiguousarray(flat[:, fbs:fbs + n_scols])


def fill_next_state64(n_cols_parent: int, n_rows_parent: int, state):
    """State advanced past a full natural-row-major parent fill: incr by
    ceil(n_cols_parent / w) * n_rows_parent (compute_next_state,
    dense_skops.hh:173-191 — identical arithmetic to the x32 path with w
    in counter WORDS)."""
    _, w, _, _ = GENERATORS_X64[state.rng]
    per_row = -(-n_cols_parent // w)
    return state.incr(per_row * n_rows_parent)


def isclose_to_native() -> bool:  # pragma: no cover - trivial
    """Whether the independent native C++ x64 fill is available for
    cross-checking (tests/test_x64_fill.py)."""
    from .. import native
    return native.available()
