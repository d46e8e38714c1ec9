"""Randomized Tucker decomposition (sequentially truncated HOSVD).

X (n_1, ..., n_p)  ~=  core ×_1 U_1 ×_2 U_2 ... ×_p U_p   with
orthonormal factors U_k (n_k, r_k) and core (r_1, ..., r_p): the
multilinear-rank counterpart of the TT tier (linalg/tt.py) — Tucker
keeps one orthonormal basis PER MODE and a dense core, so it wins for
moderate p with strong per-mode compressibility; TT wins for large p.

``tucker_from_dense`` is ST-HOSVD (Vannieuwenhoven et al. 2012) with
each per-mode SVD replaced by this library's HMT rangefinder
(oversample + power iteration) on the mode-k unfolding of the
ALREADY-COMPRESSED core — each mode's work shrinks as earlier modes
truncate, and every step is a batched matmul. The error satisfies
the ST-HOSVD identity ||X - X_hat||^2 = sum_k eps_k^2 (per-mode
truncation errors are orthogonal), so randomized per-mode
quasi-optimality lifts to the full decomposition.

Streams: one seed-chained Gaussian sketch per mode;
next_state = f(shape, ranks) only (the library-wide contract).

Reference analog: none (matrix-only library); this rides its
rangefinder exactly as svd_rank1_plus_noise.cc rides the reference's.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..base import require
from ..dense import DenseDist, fill_dense
from ..rng.state import RNGState
from .qb import _orth, _stabilize


def tucker_full(core: jax.Array, factors: Sequence[jax.Array]
                ) -> jax.Array:
    """Contract (core, factors) back to the dense tensor."""
    require(core.ndim == len(factors),
            "need one factor per core mode")
    out = core
    for k, u in enumerate(factors):
        out = jnp.moveaxis(
            jnp.tensordot(u, out, axes=(1, k)), 0, k)
    return out


def tucker_from_dense(x: jax.Array, ranks, state: RNGState, *,
                      oversample: int = 8, power_iters: int = 1,
                      dtype=jnp.float32, orth: str = "cholqr"
                      ) -> Tuple[jax.Array, List[jax.Array], RNGState]:
    """Randomized ST-HOSVD: returns ``(core, factors, next_state)``.

    For each mode in order, range-find the mode-k unfolding of the
    current core with an oversampled Gaussian sketch + ``power_iters``
    subspace iterations, take U_k = the orthonormal basis truncated to
    r_k through the small factor's SVD, and replace the core by
    U_k^T ×_k core. Requested ranks are clipped to each unfolding's
    feasible min(rows, cols)."""
    shape = tuple(int(n) for n in x.shape)
    p = len(shape)
    require(p >= 1, "tucker_from_dense needs ndim >= 1")
    if isinstance(ranks, int):
        rr = [ranks] * p
    else:
        rr = [int(r) for r in ranks]
        require(len(rr) == p, "ranks must be a scalar or length ndim")
    require(all(r >= 1 for r in rr), "Tucker ranks must be >= 1")

    core = x.astype(dtype)
    factors: List[jax.Array] = []
    st = state
    for k in range(p):
        cur = core.shape
        rest = 1
        for i, n in enumerate(cur):
            if i != k:
                rest *= n
        mat = jnp.moveaxis(core, k, 0).reshape(cur[k], rest)
        r_k = min(rr[k], cur[k], rest)
        rr[k] = r_k
        s = min(r_k + oversample, cur[k], rest)
        g, st = fill_dense(DenseDist(rest, s), st, dtype=dtype)
        y = jnp.matmul(mat, g, preferred_element_type=dtype)
        for _ in range(power_iters):
            q = _stabilize(y, orth)
            z = jnp.matmul(mat.T, q, preferred_element_type=dtype)
            w = _stabilize(z, orth)
            y = jnp.matmul(mat, w, preferred_element_type=dtype)
        q = _orth(y, orth)                        # (n_k, s)
        b = jnp.matmul(q.T, mat, preferred_element_type=dtype)
        if s > r_k:                               # truncate via small SVD
            from .qb import safe_svd
            ub, sv, vt = safe_svd(b, full_matrices=False)
            q = jnp.matmul(q, ub[:, :r_k],
                           preferred_element_type=dtype)
            b = sv[:r_k, None] * vt[:r_k, :]
        factors.append(q)                         # (n_k, r_k)
        core = jnp.moveaxis(
            b.reshape((r_k,) + cur[:k] + cur[k + 1:]), 0, k)
    return core, factors, st
