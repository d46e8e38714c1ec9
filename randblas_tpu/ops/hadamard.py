"""Walsh–Hadamard transform as dense matmuls.

The workhorse of the SRHT sketching operator (randblas_tpu/trig.py).
Accelerator design: no butterfly loops — H_m for m = 2^L factorizes as a
Kronecker product H_m = H_{f1} (x) ... (x) H_{fk} (Sylvester's
construction), so the transform of an (m, n) block is k dense
contractions with small constant +-1 matrices. Factors are balanced
powers of two, so every contraction is a GEMM of useful depth; total cost is m*n*sum(f_i) MACs ~= m n log2(m) *
(128/7) — for m = 65536 that is ~37 m*n MACs, versus d*m*n for a dense
Gaussian sketch (d is typically 256-4096), so the transform stage is
10-100x cheaper than a dense sketch of the same data.

No reference analog: RandBLAS has no trig/Hadamard operator family; this
module exists to support the beyond-parity TrigSkOp. The matrices are
+-1-valued, so reduced-precision operand rounding leaves them exact;
accumulation stays f32.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..base import require


def is_pow2(m: int) -> bool:
    return m >= 1 and (m & (m - 1)) == 0


def next_pow2(m: int) -> int:
    p = 1
    while p < m:
        p <<= 1
    return p


def _balanced_factors(m: int, max_factor: int = 128) -> list:
    """Split m = 2^L into balanced power-of-two factors, each
    <= max_factor.

    Balancing keeps the smallest factor as large as possible (e.g.
    2^16 at cap 128 -> [64, 32, 32] rather than greedy [128, 128, 4])
    so every contraction has GEMM-worthy depth. Each stage is one full
    memory pass over the block, so a LARGER cap trades flops (sum of
    factors) for fewer passes — the transform is bandwidth-bound at
    big m."""
    lg = m.bit_length() - 1
    if lg == 0:
        return [1]
    cap_lg = max(max_factor.bit_length() - 1, 1)
    stages = -(-lg // cap_lg)
    base, extra = divmod(lg, stages)
    return [1 << (base + (1 if s < extra else 0)) for s in range(stages)]


@functools.lru_cache(maxsize=None)
def _hadamard_np(k: int):
    """H_k (+-1, Sylvester/natural ordering): H[i, j] = (-1)^popcount(i & j)."""
    i = np.arange(k, dtype=np.uint32)
    x = i[:, None] & i[None, :]
    parity = np.zeros_like(x)
    for b in range(max(k.bit_length() - 1, 1)):
        parity ^= (x >> b) & 1
    return np.where(parity, -1.0, 1.0).astype(np.float32)


def hadamard_matrix(k: int, dtype=jnp.float32) -> jax.Array:
    """The k x k +-1 Walsh–Hadamard matrix (natural/Hadamard ordering)."""
    require(is_pow2(k), "Hadamard order must be a power of two")
    return jnp.asarray(_hadamard_np(k), dtype=dtype)


def hadamard_transform(x: jax.Array, max_factor: int = 512,
                       precision=None) -> jax.Array:
    """H_m @ x for x of shape (m, n), m a power of two. Unnormalized
    (H H^T = m I); divide by sqrt(m) for the orthonormal transform.

    ``max_factor`` caps the per-stage Kronecker factor (a power of two
    in [2, 4096]); every stage costs one memory pass over the block plus
    2*m*n*factor flops, so the transform is bandwidth-bound and larger
    caps cut passes (512: two passes at m = 2^16). The H100 crossover is
    not measured yet.

    ``precision`` forwards to the stage contractions (None = backend
    default: TF32 operands on the GPU, like every other f32 GEMM here;
    'highest' = full-f32 stages — the transform is bandwidth-bound, so
    this mainly matters for tight numerical cross-checks,
    tests/test_gpu_hardware.py).

    Differentiable and jittable; the transform is its own transpose
    (H symmetric), so the VJP is another Hadamard transform for free.
    """
    require(x.ndim == 2, "hadamard_transform expects an (m, n) block")
    require(is_pow2(max_factor) and 2 <= max_factor <= 4096,
            "max_factor must be a power of two in [2, 4096]")
    m = x.shape[0]
    require(is_pow2(m), "leading dimension must be a power of two "
                        "(pad rows with zeros; see trig.py)")
    if m == 1:
        return x
    hiprec = False
    if jnp.dtype(x.dtype) == jnp.float64:
        # f64 stage contractions follow the same policy as every other
        # dense f64 product (skge._matmul). Deferred import: skge imports
        # trig imports this module.
        from ..skge import _hiprec_route
        hiprec = _hiprec_route(x.dtype)
    factors = _balanced_factors(m, max_factor)
    y = x.reshape(*factors, x.shape[1])
    for ax, f in enumerate(factors):
        h = hadamard_matrix(f, x.dtype)
        if hiprec:
            from .f64gemm import matmul_hiprec
            y0 = jnp.moveaxis(y, ax, 0)
            rest = y0.shape[1:]
            z = matmul_hiprec(h, y0.reshape(f, -1))
            y = jnp.moveaxis(z.reshape((f,) + rest), 0, ax)
        else:
            y = jnp.moveaxis(jnp.tensordot(h, y, axes=([1], [ax]),
                                           precision=precision), 0, ax)
    return y.reshape(m, x.shape[1])
