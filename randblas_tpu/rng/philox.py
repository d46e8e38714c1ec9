"""Philox counter-based RNGs (Philox4x32, Philox2x32) in pure JAX uint32 ops.

Independent implementation of the Philox algorithm (Salmon et al., SC'11,
"Parallel random numbers: as easy as 1, 2, 3"), validated bit-for-bit against
the upstream Random123 known-answer vectors — the same vectors the reference
library tests against (test/test_basic_rng/test_r123.cc:145-200,
r123_kat_vectors.txt).

All functions are shape-polymorphic: counters have shape (..., W) where W is
the counter width in 32-bit words; keys are broadcast along the leading dims.
Everything is uint32, so the same code runs under jit on GPU/CPU and inside
Pallas kernels.
"""

from __future__ import annotations

import jax.numpy as jnp

from .bits import mul32_wide

# Philox multipliers / Weyl constants (public algorithm constants).
# Kept as python ints: jnp scalars are materialized *inside* each traced
# function so Pallas kernels don't see captured constants.
PHILOX_M4x32_0 = 0xD2511F53
PHILOX_M4x32_1 = 0xCD9E8D57
PHILOX_M2x32_0 = 0xD256D193
PHILOX_W32_0 = 0x9E3779B9
PHILOX_W32_1 = 0xBB67AE85


def philox4x32_words(x0, x1, x2, x3, k0, k1, rounds: int = 10):
    """Philox-4x32 on separate uint32 word arrays (no stacking).

    This word-wise form is shared by the batched JAX path and Pallas
    kernels, where keeping the four counter words as independent 2-D
    arrays avoids minor-dim relayouts.
    """
    m0 = jnp.uint32(PHILOX_M4x32_0)
    m1 = jnp.uint32(PHILOX_M4x32_1)
    w0 = jnp.uint32(PHILOX_W32_0)
    w1 = jnp.uint32(PHILOX_W32_1)
    for r in range(rounds):
        if r > 0:
            k0 = k0 + w0
            k1 = k1 + w1
        hi0, lo0 = mul32_wide(m0, x0)
        hi1, lo1 = mul32_wide(m1, x2)
        x0 = hi1 ^ x1 ^ k0
        x1 = lo1
        x2 = hi0 ^ x3 ^ k1
        x3 = lo0
    return x0, x1, x2, x3


def philox4x32(ctr, key, rounds: int = 10):
    """Philox-4x32 with the given number of rounds (default 10).

    ctr: uint32[..., 4], key: uint32[..., 2] (broadcastable against ctr's
    leading dims). Returns uint32[..., 4].
    """
    ctr = jnp.asarray(ctr, dtype=jnp.uint32)
    key = jnp.asarray(key, dtype=jnp.uint32)
    out = philox4x32_words(ctr[..., 0], ctr[..., 1], ctr[..., 2],
                           ctr[..., 3], key[..., 0], key[..., 1], rounds)
    return jnp.stack(out, axis=-1)


def philox2x32(ctr, key, rounds: int = 10):
    """Philox-2x32. ctr: uint32[..., 2], key: uint32[..., 1]."""
    ctr = jnp.asarray(ctr, dtype=jnp.uint32)
    key = jnp.asarray(key, dtype=jnp.uint32)
    x0, x1 = ctr[..., 0], ctr[..., 1]
    k0 = key[..., 0]
    w0 = jnp.uint32(PHILOX_W32_0)
    m0 = jnp.uint32(PHILOX_M2x32_0)
    for r in range(rounds):
        if r > 0:
            k0 = k0 + w0
        hi, lo = mul32_wide(m0, x0)
        x0 = hi ^ k0 ^ x1
        x1 = lo
    return jnp.stack([x0, x1], axis=-1)
