"""Low-level uint32 arithmetic helpers shared by the JAX and Pallas RNG paths.

JAX runs without x64 mode by default, and Pallas kernels cannot rely on
it. Everything here is expressed in uint32 ops (wraparound add/mul,
shifts, xor) so the same building blocks work in plain jitted JAX, inside
Pallas kernels, and on CPU test meshes.

Counterpart of the Random123 integer plumbing used by the reference
(RandBLAS/random_gen.hh:73-78 includes; counter semantics pinned by
test/test_basic_rng/test_r123.cc:686-766).
"""

from __future__ import annotations

import jax.numpy as jnp

U32 = jnp.uint32

_MASK16 = 0xFFFF


def _u32(x):
    return jnp.asarray(x, dtype=jnp.uint32)


def mul32_wide(a, b):
    """Full 32x32 -> 64 bit unsigned multiply, returned as (hi, lo) uint32.

    Implemented with 16-bit limb splits so it lowers to plain uint32
    multiplies (no uint64 required).
    """
    a = _u32(a)
    b = _u32(b)
    a_lo = a & _MASK16
    a_hi = a >> 16
    b_lo = b & _MASK16
    b_hi = b >> 16
    t = a_lo * b_lo                      # <= (2^16-1)^2 < 2^32
    u = a_hi * b_lo + (t >> 16)          # < 2^32
    v = a_lo * b_hi + (u & _MASK16)      # < 2^32
    hi = a_hi * b_hi + (u >> 16) + (v >> 16)
    lo = a * b                           # wraparound low half
    return hi, lo


def mul32_hi(a, b):
    """High 32 bits of the 64-bit product a*b (Philox mulhi)."""
    hi, _ = mul32_wide(a, b)
    return hi


def rotl32(x, r):
    """Rotate-left on uint32 (Threefry)."""
    x = _u32(x)
    r = int(r)
    return (x << U32(r)) | (x >> U32(32 - r))


def add64_split(amount):
    """Split a nonnegative python int (< 2**64) into (lo32, hi32) ints."""
    amount = int(amount)
    if amount < 0:
        raise ValueError("counter increments must be nonnegative")
    return amount & 0xFFFFFFFF, (amount >> 32) & 0xFFFFFFFF


def add_carry(a, b):
    """(a + b) mod 2^32 and the carry-out bit, both uint32."""
    a = _u32(a)
    b = _u32(b)
    s = a + b
    carry = (s < b).astype(jnp.uint32)
    return s, carry


def ctr_add64_words(ctr, lo, hi=0):
    """``ctr_add64`` without the final stack: returns the counter word
    *planes* as a tuple. When lo/hi are (..., )-shaped arrays, each plane
    broadcasts to that shape — the form the word-wise generators consume
    directly, avoiding the minor-dim-W layout that the stacked counter
    array forces (see ops/dense_fill.py::fill_colmajor)."""
    ctr = jnp.asarray(ctr, dtype=jnp.uint32)
    lo = _u32(lo)
    hi = _u32(hi)
    n = ctr.shape[-1]
    c0, carry = add_carry(ctr[..., 0], lo)
    out = [c0]
    if n == 2:
        c1 = ctr[..., 1] + hi + carry
        out.append(c1)
    else:
        t, ca = add_carry(ctr[..., 1], hi)
        c1, cb = add_carry(t, carry)
        carry1 = ca | cb
        out.append(c1)
        c2, carry2 = add_carry(ctr[..., 2], carry1)
        out.append(c2)
        rest = [ctr[..., i] for i in range(3, n)]
        acc = carry2
        for i, w in enumerate(rest):
            cw, acc = add_carry(w, acc)
            out.append(cw)
    return tuple(out)


def ctr_add64(ctr, lo, hi=0):
    """Add a 64-bit amount (given as uint32 limbs lo, hi) to a little-endian
    multiword uint32 counter array, propagating carries.

    Matches Random123 ``ctr.incr(n)`` semantics: the counter is read as a
    base-2^32 little-endian integer (RandBLAS test_r123.cc:686-766).

    ctr: uint32[len_c] (len_c in {2, 4}); lo/hi: scalar uint32 (python int or
    traced). Returns the new counter array.
    """
    out = ctr_add64_words(ctr, lo, hi)
    return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)


def mul64_u32(a, b):
    """(a * b) as 64-bit split (lo, hi) where a, b are uint32 scalars/arrays.

    Used to compute counter offsets like row * ctr_stride without uint64.
    """
    hi, lo = mul32_wide(a, b)
    return lo, hi


def add64(lo_a, hi_a, lo_b, hi_b):
    """64-bit add on (lo, hi) uint32 pairs."""
    lo, carry = add_carry(_u32(lo_a), _u32(lo_b))
    hi = _u32(hi_a) + _u32(hi_b) + carry
    return lo, hi
