"""Randomly pivoted (partial) Cholesky for PSD low-rank approximation.

Block RPCholesky (Chen–Epperly–Tropp–Webber 2022, alg. 3): draw a block
of pivot columns with probability proportional to the residual diagonal,
form the residual columns G = A[:, S] - F F[S, :]^T, and absorb them
through the inverse square root of the pivot Gram block. The result
A ~= F F^T matches the best rank-k approximation in trace norm up to a
modest oversampling factor, while touching only ``rank`` columns of A —
the column-access counterpart of the sketch-based nystrom() (which
touches A once through d dense matvecs).

Library-tier consumer of the counter-based sampling core — pivots come
from util.sample_indices_iid, so runs are deterministic in the RNGState
and the consumed stream is seed-chained like every other consumer (the
reference's inverse-CDF sampler, /root/reference/RandBLAS/util.hh:285-306,
is the same primitive; the reference ships no RPCholesky).

Accelerator notes: each block step is one (n, b) column gather, one (n, r)x(r, b)
GEMM, and one b x b eigh — GEMM-shaped except the tiny eigh. The pivot
Gram block is inverted through eigh with relative clipping rather than
Cholesky, so duplicate pivots inside a block (possible: the draw is iid)
only shed the redundant directions instead of breaking a triangular
factor. Fully jittable: block sizes are static and the pivot gather is
jnp.take.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..base import require
from ..rng.state import RNGState
from ..util import sample_indices_iid
from .qb import _mm_precise, safe_svd


def _inv_sqrt_psd(h: jax.Array) -> jax.Array:
    """Pseudo inverse square root of a (b, b) PSD block via eigh with
    relative eigenvalue clipping (duplicate/degenerate pivots make the
    block exactly rank-deficient; clipped directions produce zero
    columns in F, which are harmless)."""
    b = h.shape[0]
    w, v = jnp.linalg.eigh(0.5 * (h + h.T))
    cutoff = jnp.finfo(h.dtype).eps * b * jnp.maximum(
        jnp.max(w), jnp.finfo(h.dtype).tiny)
    inv_root = jnp.where(w > cutoff, 1.0 / jnp.sqrt(jnp.maximum(w, cutoff)),
                         0.0)
    return jnp.matmul(v * inv_root[None, :], v.T,
                      precision=jax.lax.Precision.HIGHEST)


def rpcholesky(a, rank: int, state: RNGState, *, block: int = None,
               n: int = None, diag=None
               ) -> Tuple[jax.Array, jax.Array, RNGState]:
    """Rank-``rank`` partial Cholesky A ~= F @ F.T of PSD ``a`` with
    randomly chosen pivots.

    ``a`` is a dense (n, n) PSD array, or a column oracle
    ``a(idx: int32[b]) -> A[:, idx]`` (pass ``n`` and ``diag`` — the
    kernel-matrix use case: only ``rank`` kernel columns are ever
    evaluated). ``block`` pivots are drawn per step (default
    ``min(rank, 64)``); the last block is truncated so exactly ``rank``
    columns come back.

    Returns ``(f, pivots, next_state)`` with ``f`` (n, rank),
    ``pivots`` int32 (rank,) the chosen column indices (a pivot drawn
    redundantly inside one block is kept in the log but contributes a
    zero column), and the seed-chained next state. The residual
    diagonal of the approximation is ``diag(A) - sum(f**2, axis=1)``.
    """
    if callable(a):
        require(n is not None and diag is not None,
                "a column-oracle a needs explicit n and diag")
        d0 = jnp.asarray(diag)
        require(d0.shape == (n,), "diag must have shape (n,)")
        cols_of = a
    else:
        require(a.ndim == 2 and a.shape[0] == a.shape[1],
                "rpcholesky needs a square PSD matrix or a column oracle")
        n = a.shape[0]
        d0 = jnp.diagonal(a)
        cols_of = lambda idx: jnp.take(a, idx, axis=1)
    require(1 <= rank <= n, "rank must be in [1, n]")
    b = min(rank, 64) if block is None else min(block, rank)
    require(b >= 1, "block must be >= 1")

    dtype = d0.dtype
    f = jnp.zeros((n, rank), dtype)
    pivots = jnp.zeros((rank,), jnp.int32)
    d_res = jnp.maximum(d0, 0.0).astype(dtype)
    st = state
    tiny = jnp.finfo(dtype).tiny

    lo = 0
    while lo < rank:
        bt = min(b, rank - lo)
        # residual-diagonal sampling distribution; once the residual is
        # numerically zero the approximation is already exact — fall
        # back to uniform so the CDF stays well-formed (the extra
        # pivots' directions are shed by the Gram clipping).
        w = jnp.maximum(d_res, 0.0)
        total = jnp.sum(w)
        w = jnp.where(total > tiny, w, jnp.ones_like(w))
        cdf = jnp.cumsum(w)
        cdf = cdf / cdf[-1]
        idx, st = sample_indices_iid(cdf, bt, st)

        g = cols_of(idx).astype(dtype)                       # (n, bt)
        # Downdates at Precision.HIGHEST: the residual diagonal feeds
        # the pivot distribution and the Gram clipping threshold, and
        # reduced-precision default rounding otherwise floors the
        # factorization error at ~1e-1 on an accelerator while every CPU
        # test passes. These are thin (n, r) x (r, b) products — the
        # full-f32 cost is negligible.
        g = g - _mm_precise(f, jnp.take(f, idx, axis=0).T)
        h = jnp.take(g, idx, axis=0)                         # (bt, bt)
        fb = _mm_precise(g, _inv_sqrt_psd(h))                # (n, bt)
        f = jax.lax.dynamic_update_slice(f, fb, (0, lo))
        pivots = jax.lax.dynamic_update_slice(pivots, idx, (lo,))
        d_res = jnp.maximum(d_res - jnp.sum(fb * fb, axis=1), 0.0)
        d_res = d_res.at[idx].set(0.0)
        lo += bt
    return f, pivots, st


def rpcholesky_pcg(a, bvec, state: RNGState, *, rank: int, mu: float = 0.0,
                   block: int = None, tol: float = None, maxiter: int = 500
                   ) -> Tuple[jax.Array, jax.Array, RNGState]:
    """Solve ``(A + mu I) x = b`` by CG preconditioned with an RPCholesky
    approximation of PSD ``a`` — the column-sampling counterpart of
    nystrom_pcg (same preconditioner algebra; the low-rank factor comes
    from ``rank`` column accesses instead of a dense sketch pass, the
    right trade when single columns of A are cheap, e.g. kernel
    matrices).

    ``a`` is a dense (n, n) PSD array; ``bvec`` is (n,) or (n, k).
    Returns ``(x, iterations, next_state)``.
    """
    require(not callable(a),
            "rpcholesky_pcg needs a dense A for the CG matvecs; build "
            "the preconditioner from rpcholesky() directly for operator A")
    vec = bvec.ndim == 1
    bb = bvec[:, None] if vec else bvec
    n = bb.shape[0]
    f, _, nxt = rpcholesky(a, rank, state, block=block)
    # Eigendecompose F F^T through the skinny factor: F = U S V^T gives
    # A ~= U diag(S^2) U^T — the same (u, lam) form nystrom() returns.
    u, s, _ = safe_svd(f.astype(bb.dtype), full_matrices=False)
    lam = s * s
    lam_reg = lam + mu
    eps = jnp.finfo(bb.dtype).eps
    cutoff = jnp.maximum(eps * lam_reg[0], jnp.finfo(bb.dtype).tiny)
    kept = lam_reg > cutoff
    lam_d = jnp.min(jnp.where(kept, lam_reg, jnp.inf))
    lam_d = jnp.where(jnp.isfinite(lam_d), lam_d, lam_reg.dtype.type(1.0))
    safe = jnp.maximum(lam_reg, cutoff)
    scale = jnp.where(kept, lam_d / safe, 1.0)[:, None]
    u = u.astype(bb.dtype)

    def pinv(v):
        w = u.T @ v
        return u @ (scale * w) + (v - u @ w)

    op = (lambda x: a @ x + mu * x) if mu else (lambda x: a @ x)
    if tol is None:
        tol = 100.0 * float(jnp.finfo(bb.dtype).eps)
    from .lstsq import _pcg
    x, k = _pcg(op, bb, pinv=pinv, tol=tol, maxiter=maxiter)
    return (x[:, 0] if vec else x), k, nxt
