"""Transforms from raw uint32 CBRNG output to floating-point samples.

Counterpart of r123ext::boxmul / r123ext::uneg11
(RandBLAS/random_gen.hh:81-177) and the Random123 uniform.hpp/boxmuller.hpp
mappings they wrap.

Semantics pinned to the 32-bit-counter case (Philox4x32/Threefry4x32):
the float transform is computed in float32, then promoted to the requested
dtype — exactly like the reference, where ``boxmulall``/``uneg11all`` deduce
float from 32-bit counter words and ``copy_promote`` widens into a double
buffer (dense_skops.hh:50-55,156).

Bit-exactness contract: the uint32 stream is bit-identical to Random123
(KAT-tested), and the uneg11/u01 uniform maps are exact float arithmetic.
The Box-Muller Gaussian map goes through log/sin/cos, whose float32
accuracy is implementation-defined (XLA's CPU f32 log is ~3e-4 relative vs
libm; GPU libdevice transcendentals differ again), so Gaussian streams are
reproducible bitwise *within* one platform+compiler but only to ~1e-3
relative across platforms (see SURVEY.md §7 hard part 1). Statistical
quality is unaffected.
"""

from __future__ import annotations

import jax.numpy as jnp

# float32 constants, exactly representable. Python floats (not jnp scalars)
# so that traced functions materialize them inside the trace — required for
# Pallas kernels, which reject captured constants.
_U01_FACTOR = 2.0 ** -32
_U01_HALF = 2.0 ** -33
_UNEG11_FACTOR = 2.0 ** -31
_UNEG11_HALF = 2.0 ** -32
_PI = 3.1415926535897932


def u01(bits):
    """uint32 -> float32 uniform on (0, 1): u * 2^-32 + 2^-33.

    Matches r123::u01<float, uint32_t> (Random123 uniform.hpp).
    """
    bits = jnp.asarray(bits, dtype=jnp.uint32)
    return (bits.astype(jnp.float32) * jnp.float32(_U01_FACTOR)
            + jnp.float32(_U01_HALF))


def u01fixedpt(bits):
    """uint32 -> float32 "fixed point" uniform on (0, 1): odd multiples of
    2^-B with B = min(mantissa bits, word width) = 24, i.e.
    ((u >> 8) | 1) * 2^-24.

    Matches r123::u01fixedpt<float, uint32_t> (Random123 uniform.hpp):
    every output is exactly representable (no rounding), the smallest is
    2^-24 and the largest 1 - 2^-24, all equally likely. The reference
    exercises it in test_r123.cc:607-625 (fixed-histogram tier).
    """
    bits = jnp.asarray(bits, dtype=jnp.uint32)
    odd = (bits >> jnp.uint32(8)) | jnp.uint32(1)
    return odd.astype(jnp.float32) * jnp.float32(2.0 ** -24)


def uneg11(bits):
    """uint32 -> float32 uniform on (-1, 1): int32(u) * 2^-31 + 2^-32.

    Matches r123::uneg11<float, uint32_t>: the word is reinterpreted as a
    signed int32 before scaling.
    """
    bits = jnp.asarray(bits, dtype=jnp.uint32)
    signed = bits.astype(jnp.int32)  # two's-complement reinterpretation
    return (signed.astype(jnp.float32) * jnp.float32(_UNEG11_FACTOR)
            + jnp.float32(_UNEG11_HALF))


def uneg11_i32(signed):
    """uneg11 on an already-signed int32 view of the word (for Pallas,
    where uint32->float casts are unsupported; int32->float is native)."""
    return (signed.astype(jnp.float32) * jnp.float32(_UNEG11_FACTOR)
            + jnp.float32(_UNEG11_HALF))


def u01_i32(signed):
    """u01 on a signed int32 view: u = s + 2^32*[s<0], so
    u*2^-32 + 2^-33 = s*2^-32 + 2^-33 + [s<0].

    Rounding can differ from the direct unsigned conversion by ~1 ulp
    (double rounding) — covered by the documented float tolerance.
    """
    base = (signed.astype(jnp.float32) * jnp.float32(_U01_FACTOR)
            + jnp.float32(_U01_HALF))
    return base + jnp.where(signed < 0, jnp.float32(1.0), jnp.float32(0.0))


def boxmul_pair_i32(s_even, s_odd):
    """Box-Muller on signed int32 word views (Pallas-safe: no uint32 ->
    float conversion)."""
    u = uneg11_i32(s_even)
    r = jnp.sqrt(jnp.float32(-2.0) * jnp.log(u01_i32(s_odd)))
    ang = jnp.float32(_PI) * u
    return jnp.sin(ang) * r, jnp.cos(ang) * r


def boxmul_pair(u_even, u_odd):
    """Box-Muller on a pair of uint32 words -> two standard normals (f32).

    Matches r123::boxmuller(u0, u1) (Random123 boxmuller.hpp):
        x = sin(pi * uneg11(u0)) * r,  y = cos(pi * uneg11(u0)) * r,
        r = sqrt(-2 ln u01(u1)).
    """
    ang = jnp.float32(_PI) * uneg11(u_even)
    r = jnp.sqrt(jnp.float32(-2.0) * jnp.log(u01(u_odd)))
    return jnp.sin(ang) * r, jnp.cos(ang) * r


def boxmul_block(block):
    """Apply Box-Muller pairwise over the last axis of a uint32[..., W] block
    (W even). Counterpart of r123ext::boxmulall (random_gen.hh:96-110).
    Returns float32 of the same shape.
    """
    block = jnp.asarray(block, dtype=jnp.uint32)
    w = block.shape[-1]
    assert w % 2 == 0
    outs = []
    for i in range(w // 2):
        v0, v1 = boxmul_pair(block[..., 2 * i], block[..., 2 * i + 1])
        outs.append(v0)
        outs.append(v1)
    return jnp.stack(outs, axis=-1)


def uneg11_block(block):
    """uneg11 over every word of a uint32[..., W] block -> float32[..., W].

    Counterpart of r123::uneg11all via r123ext::uneg11::generate
    (random_gen.hh:148-173).
    """
    return uneg11(block)
