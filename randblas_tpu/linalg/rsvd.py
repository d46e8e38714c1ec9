"""Randomized truncated SVD (Halko–Martinsson–Tropp) on top of QB.

The one-call form of the reference's svd_rank1_plus_noise.cc:217-300
pipeline (rangefinder -> QB -> small SVD), as a library function:
oversampled rangefinder with power iteration, then truncation to the
requested rank. Dense and sparse (COO/CSR/CSC) data both supported.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..base import require
from ..rng.state import RNGState
from .qb import qb_decompose, qb_to_svd


def rsvd(a, rank: int, state: RNGState, oversample: int = 8,
         power_iters: int = 2, dtype=jnp.float32,
         operator: str = "gaussian", orth: str = "cholqr"
         ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Rank-``rank`` approximate SVD: returns (u, s, vt) with u (m, rank),
    s (rank,), vt (rank, n). ``oversample`` extra sketch columns and
    ``power_iters`` subspace iterations sharpen the tail (HMT 2011
    recommends 5-10 and 1-2 respectively). ``operator`` picks the
    rangefinder embedding ('gaussian' | 'saso' | 'srht'; see
    rangefinder); ``orth`` the orthonormalizer ('cholqr' all-GEMM, 'qr'
    for extreme conditioning)."""
    n_rows, n_cols = a.shape
    k = rank + oversample
    require(rank >= 1, "rank must be >= 1")
    require(k <= min(n_rows, n_cols),
            "rank + oversample must be <= min(A.shape)")
    q, b = qb_decompose(a, k, state, power_iters=power_iters, dtype=dtype,
                        operator=operator, orth=orth)
    u, s, vt = qb_to_svd(q, b)
    return u[:, :rank], s[:rank], vt[:rank, :]


def rsvd_adaptive(a, tol: float, state: RNGState, *, block: int = 16,
                  max_rank: int = None, dtype=jnp.float32):
    """Truncated SVD at an ERROR target instead of a rank target: grow
    the basis with :func:`~randblas_tpu.linalg.adaptive_rangefinder`
    until its HMT certificate clears ``tol`` (Frobenius-scale — see the
    rangefinder's docstring for choosing it), then compress. Returns
    ``(u, s, vt, bound, next_state)`` with data-dependent rank =
    ``len(s)`` and ``bound`` the certified residual estimate — the
    "give me everything above this noise floor" form of :func:`rsvd`.
    """
    from .qb import _apply_t, _is_sparse, adaptive_rangefinder, qb_to_svd
    q, bound, nxt = adaptive_rangefinder(a, tol, state, block=block,
                                         max_rank=max_rank, dtype=dtype)
    if q.shape[1] == 0:
        m, n = a.shape
        return (jnp.zeros((m, 0), dtype), jnp.zeros((0,), dtype),
                jnp.zeros((0, n), dtype), bound, nxt)
    b = _apply_t(a, q).T if _is_sparse(a) else jnp.matmul(
        q.T, a.astype(dtype), preferred_element_type=dtype)
    u, s, vt = qb_to_svd(q, b)
    return u, s, vt, bound, nxt
