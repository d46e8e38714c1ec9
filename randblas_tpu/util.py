"""Utilities: CDF sampling, symmetry helpers.

Counterpart of RandBLAS/util.hh. The buffer-manipulation helpers
(omatcopy/flip_layout/transpose_square) have no role on jnp arrays; the
statistically meaningful utilities are ported with identical stream
semantics.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .base import require
from .rng.state import RNGState
from .rng.transforms import uneg11_block


def weights_to_cdf(w, error_if_below: float = None):
    """Nonnegative weights -> normalized cumulative distribution
    (util.hh:258-270). Jittable except for the negativity check, which runs
    host-side when the input is concrete."""
    w = jnp.asarray(w)
    n = w.shape[0]
    eps = jnp.finfo(w.dtype).eps
    floor = -eps if error_if_below is None else error_if_below
    try:
        import numpy as np
        wn = np.asarray(w)
        require(bool((wn >= floor).all()),
                "weights must be >= the error threshold")
    except jax.errors.TracerArrayConversionError:
        pass
    w = jnp.maximum(w, 0.0)
    cdf = jnp.cumsum(w)
    total = cdf[-1]
    return cdf / total


def _uniform_stream_bits(state: RNGState, k: int):
    """Raw uint32 words consuming counters exactly like the reference's
    sample_indices_iid loop (util.hh:285-306).

    Quirk reproduced faithfully: the reference generates a block at the
    initial counter before its loop, but its refresh condition
    ``(i+1) % len_c == 1`` fires already at i=0, so that first block is
    *discarded* — sample i reads block (1 + i // len_c), lane (i % len_c),
    and the returned state is advanced by ceil(k / len_c).
    """
    len_c = state.len_c
    n_blocks = -(-k // len_c)  # ceil
    offsets = jnp.arange(1, n_blocks + 1, dtype=jnp.uint32)
    from .rng.bits import ctr_add64
    counters = ctr_add64(state.counter, offsets, jnp.uint32(0))
    blocks = state.generate(counters, state.key)       # (n_blocks, len_c)
    next_state = state.incr(n_blocks)
    return blocks.reshape(-1)[:k], next_state


def _uniform_stream(state: RNGState, k: int):
    """k uneg11 float32s from _uniform_stream_bits."""
    bits, next_state = _uniform_stream_bits(state, k)
    return uneg11_block(bits), next_state


def _uneg11_f64(bits_np):
    """uneg11 on uint32 words in float64 — the reference's T=double path
    (r123::uneg11<double, uint32_t>): int32 reinterpretation, then
    s * 2^-31 + 2^-32 evaluated in double."""
    import numpy as np
    signed = bits_np.astype(np.uint32).astype(np.int64)
    signed = np.where(signed >= 2 ** 31, signed - 2 ** 32, signed)
    return signed.astype(np.float64) * 2.0 ** -31 + 2.0 ** -32


def sample_indices_iid(cdf, k: int, state: RNGState):
    """k iid samples from the distribution over {0..n-1} given by `cdf`
    (inverse-CDF via searchsorted; util.hh:285-306).

    The reference computes in T=double; on concrete inputs the uneg11 map
    and the CDF comparison run host-side in float64 to match its streams.
    Under jit the computation is float32 (documented divergence for CDFs
    with features finer than 2^-24).

    Returns (samples int32[k], next_state)."""
    cdf = jnp.asarray(cdf)
    bits, next_state = _uniform_stream_bits(state, k)
    if not (isinstance(bits, jax.core.Tracer)
            or isinstance(cdf, jax.core.Tracer)):
        import numpy as np
        bits_np = np.asarray(jax.device_get(bits))
        cdf_np = np.asarray(jax.device_get(cdf), dtype=np.float64)
        u01 = (_uneg11_f64(bits_np) + 1.0) / 2.0
        samples = np.searchsorted(cdf_np, u01, side="left")
        return jnp.asarray(samples, dtype=jnp.int32), next_state
    u01 = (uneg11_block(bits).astype(cdf.dtype) + 1.0) / 2.0
    samples = jnp.searchsorted(cdf, u01, side="left")
    return samples.astype(jnp.int32), next_state


def sample_indices_iid_uniform(n: int, k: int, state: RNGState):
    """k iid samples uniform over {0..n-1} (util.hh:312-334).

    The reference computes n * u01 in T=double; float32 has a 24-bit
    mantissa, so for large n the f32 stream diverges. On concrete inputs
    the whole map runs host-side in float64 (matching the reference for
    any n < 2^31); under jit it is float64 when x64 is enabled, else
    float32 (documented divergence for n > ~2^24)."""
    bits, next_state = _uniform_stream_bits(state, k)
    if not isinstance(bits, jax.core.Tracer):
        import numpy as np
        bits_np = np.asarray(jax.device_get(bits))
        u01 = (_uneg11_f64(bits_np) + 1.0) / 2.0
        samples = np.floor(n * u01).astype(np.int32)
        return jnp.asarray(np.clip(samples, 0, n - 1)), next_state
    u = uneg11_block(bits)
    u01 = (u.astype(jnp.float64 if jax.config.jax_enable_x64
                    else jnp.float32) + 1.0) / 2.0
    samples = jnp.floor(n * u01).astype(jnp.int32)
    return jnp.clip(samples, 0, n - 1), next_state


def symmetrize(a, uplo: str = "upper"):
    """Copy one triangle onto the other (util.hh:119-140), functional."""
    a = jnp.asarray(a)
    require(a.ndim == 2 and a.shape[0] == a.shape[1], "a must be square")
    if uplo.lower().startswith("u"):
        upper = jnp.triu(a)
        return upper + jnp.triu(a, 1).T
    lower = jnp.tril(a)
    return lower + jnp.tril(a, -1).T


def overwrite_triangle(a, uplo: str, strict_offset: int = 1, val=0.0):
    """Set a triangle to `val` (util.hh:142-163), functional."""
    a = jnp.asarray(a)
    n = a.shape[0]
    i = jnp.arange(n)[:, None]
    j = jnp.arange(a.shape[1])[None, :]
    if uplo.lower().startswith("u"):
        mask = j >= i + strict_offset
    else:
        mask = i >= j + strict_offset
    return jnp.where(mask, jnp.asarray(val, a.dtype), a)


def transpose_square(a):
    """Transpose of a square matrix (util.hh transpose_square).

    The reference transposes in place; JAX arrays are immutable, so the
    functional form returns a.T (an O(1) view under jit — XLA fuses the
    transpose into consumers)."""
    a = jnp.asarray(a)
    require(a.ndim == 2 and a.shape[0] == a.shape[1], "a must be square")
    return a.T


def safe_scal(alpha, x):
    """alpha * x that OVERWRITES with zeros when alpha == 0, never
    multiplies (util.hh safe_scal): 0 * inf/NaN must yield 0, matching
    the library's beta == 0 contract (ops/accumulate.py)."""
    x = jnp.asarray(x)
    if isinstance(alpha, (int, float)):
        if alpha == 0:
            return jnp.zeros_like(x)
        return jnp.asarray(alpha, x.dtype) * x
    alpha = jnp.asarray(alpha, x.dtype)
    return jnp.where(alpha == 0, jnp.zeros_like(x),
                     alpha * jnp.where(alpha == 0, jnp.zeros_like(x), x))


def print_colmaj(a, label: str = ""):
    """Debug printer in column-major order (util.hh print_colmaj)."""
    import numpy as np
    a = np.asarray(a)
    if label:
        print(label)
    for r in range(a.shape[0]):
        print("  " + "  ".join(f"{a[r, c]: .6f}" for c in range(a.shape[1])))
