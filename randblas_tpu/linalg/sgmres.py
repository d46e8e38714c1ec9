"""Sketched GMRES for square (nonsymmetric) linear systems.

sGMRES (Nakatsukasa–Tropp 2021, "Fast & accurate randomized algorithms
for linear systems and eigenvalue problems", alg. 1): build an
m-dimensional Krylov basis with cheap k-truncated Arnoldi (each new
vector is orthogonalized against only the last k basis vectors, so the
basis costs O(nmk) instead of full Arnoldi's O(nm^2)), then solve the
projected problem

    y = argmin || S (A Q) y - S b ||

through a d ~ 2m row sketching operator S. The subspace embedding
guarantees the sketched residual is within (1 +- distortion) of the true
residual over the Krylov subspace, so the quasi-optimality of full GMRES
is recovered at truncated-Arnoldi cost. This fills the nonsymmetric
corner of the solver tier (cgls/_pcg cover least-squares and SPD
systems; the reference ships no iterative solvers at all — its examples
stop at TLS, which this module's sketch rides the same lskge3 dispatch
as).

Accelerator notes: the basis build is a lax.fori_loop whose body is one matvec
plus a k-vector orthogonalization window (dynamic_slice over the basis
buffer; unfilled slots are zero and orthogonalizing against them is a
no-op, so the window needs no masking). The (d, m) sketch of the basis
rides sketch_general, and the small solve is one rank-clipped
Householder-QR lstsq on a d x m matrix (qb.qr_clipped_lstsq), robust to
the near-dependence a truncated basis develops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..base import require
from ..rng.state import RNGState
from ..skge import sketch_general
from .embed import make_embedding
from .qb import make_matvec, qr_clipped_lstsq


def _warn_thin_embedding(d: int, m: int, n: int,
                         d_was_default: bool = False) -> None:
    """The quasi-optimality contract rests on S being a subspace
    embedding for an m-dimensional space: distortion ~ sqrt(m/d), so at
    d == m the guarantee degenerates entirely (the sketched residual can
    be arbitrarily far from the true one). Defaults use d = 2m + 8;
    warn when a user-supplied d leaves no oversampling headroom
    (ADVICE r3). Only the full-basis case d == m == n is exempt — the
    Krylov space is then all of R^n, GMRES is exact over it regardless
    of the embedding's distortion, and any singular-square-embedding
    damage is absorbed by the clipped solve. d == n alone is NOT exempt
    (review find, round 4: a square-over-the-data but
    thin-over-the-basis embedding still voids the contract).

    ``d_was_default`` suppresses the warning when the caller never
    passed d and the default 2m+8 was merely clamped to n (ADVICE r4:
    warning the user about a value they did not choose, with a remedy
    — raise d — that is unreachable since d <= n, is just noise; the
    basis being a large fraction of R^n is the normal near-exact
    regime, not a misuse)."""
    if d < m + 4 and not (d == m == n):
        if d_was_default:
            return
        import warnings
        remedy = ("Use d >= 2*m (the default)"
                  if 2 * m <= n else
                  f"Reduce the basis size (d cannot exceed n={n} here)")
        warnings.warn(
            f"embedding dimension d={d} has <4 rows of oversampling over "
            f"basis m={m}; the ~sqrt(m/d) distortion bound (and with it "
            "the residual estimate and quasi-optimality) is void. "
            f"{remedy} unless you accept heuristic output.",
            stacklevel=3)


def _truncated_arnoldi(matvec, b: jax.Array, m: int, k: int):
    """(Q, AQ): an (n, m) k-truncated Arnoldi basis for span{b, Ab, ...}
    and its image under A. AQ[:, j] = A @ Q[:, j] exactly (stored before
    orthogonalization of the NEXT vector, so no reconstruction error).

    Breakdown handling: a column whose post-orthogonalization norm falls
    to the rounding floor (eps-relative to ||A q_j||) is zeroed — this
    catches EXACT invariance (structured/integer A). NEAR-invariant
    directions above that floor become normalized rounding-noise
    vectors; they are benign because every consumer solves through a
    clipped solve that suppresses the dependent directions — the damped
    QR of qb.qr_clipped_lstsq (sgmres) or a singular-value-clipped SVD
    whiten (sketched_eigs)."""
    n = b.shape[0]
    dtype = b.dtype
    nrm0 = jnp.linalg.norm(b)
    q0 = jnp.where(nrm0 > 0, b / jnp.where(nrm0 > 0, nrm0, 1.0), b)
    qbuf = jnp.zeros((n, m), dtype).at[:, 0].set(q0)
    abuf = jnp.zeros((n, m), dtype)

    def body(j, carry):
        qb, ab = carry
        qj = jax.lax.dynamic_slice(qb, (0, j), (n, 1))[:, 0]
        # coerce to the basis dtype: A may be f64 (dense/sparse/callable)
        # while b is f32 under x64 — dynamic_update_slice requires an
        # exact dtype match (ADVICE r3).
        w = matvec(qj).astype(dtype)
        ab = jax.lax.dynamic_update_slice(ab, w[:, None], (0, j))
        wnrm0 = jnp.linalg.norm(w)
        # orthogonalize against the last k columns; the slice start is
        # clamped into range by dynamic_slice, and unfilled (zero)
        # columns contribute zero coefficients.
        start = jnp.maximum(j - (k - 1), 0)
        win = jax.lax.dynamic_slice(qb, (0, start), (n, k))   # (n, k)
        w = w - win @ (win.T @ w)
        w = w - win @ (win.T @ w)                             # re-orth pass
        nrm = jnp.linalg.norm(w)
        floor = jnp.finfo(dtype).eps * jnp.maximum(
            wnrm0, jnp.finfo(dtype).tiny)
        qnew = jnp.where(nrm > floor,
                         w / jnp.where(nrm > 0, nrm, 1.0),
                         jnp.zeros_like(w))
        qb = jnp.where(j + 1 < m,
                       jax.lax.dynamic_update_slice(
                           qb, qnew[:, None], (0, jnp.minimum(j + 1, m - 1))),
                       qb)
        return qb, ab

    qbuf, abuf = jax.lax.fori_loop(0, m, body, (qbuf, abuf))
    return qbuf, abuf


def sgmres(a, b: jax.Array, state: RNGState, *, basis: int = 50,
           trunc: int = 4, d: Optional[int] = None,
           operator: str = "saso", vec_nnz: int = 8, dtype=None,
           refine: int = 1
           ) -> Tuple[jax.Array, jax.Array, RNGState]:
    """Solve the square system ``A x = b`` approximately over an
    m=``basis``-dimensional Krylov subspace by sketched GMRES.

    ``a`` is (n, n) dense, sparse (COO/CSR/CSC), or a callable
    ``a(v) -> A @ v`` on (n,) vectors; ``b`` is (n,). ``trunc`` is the
    Arnoldi truncation window k (NT21 use 2-4; larger k = better basis
    conditioning, more flops); ``d`` is the embedding dimension (default
    ``min(n, 2 * basis + 8)``); ``operator`` picks the embedding family
    ('saso' | 'gaussian' | 'srht').

    Returns ``(x, sketched_relative_residual, next_state)``. The
    residual estimate is ||S(A x - b)|| / ||S b|| — within the
    embedding distortion (~ sqrt(m/d)) of the true relative residual.
    Accuracy is quasi-optimal over the subspace; for ill-conditioned A
    increase ``basis`` or run under float64.

    ``refine`` (default 1) adds that many iterative-refinement passes
    over the SAME basis: sketch the true residual ``b - A x``, solve the
    small LS problem again, correct x. Each pass costs one matvec + one
    tail sketch and multiplies the recoverable error by the solve's
    contraction factor (~1e-3 here), so one pass pins the true residual
    to the subspace optimum even where the tail sketch's
    reduced-precision products would otherwise leave a ~1e-3 component
    of the residual inside range(AQ) (measured on an accelerator — the
    hardware sgmres test sat at 1.7e-3 vs the 1e-3 bound before
    refinement).
    """
    require(b.ndim == 1, "sgmres expects a single right-hand side (n,)")
    n = b.shape[0]
    if not callable(a):
        require(a.shape == (n, n), "sgmres needs a square A matching b")
    m = int(basis)
    require(1 <= m <= n, "basis size must be in [1, n]")
    require(trunc >= 1, "trunc must be >= 1")
    k = min(trunc, m)
    d_was_default = d is None
    d = min(n, 2 * m + 8) if d is None else d
    require(d >= m, "embedding dimension d must be >= basis")
    _warn_thin_embedding(d, m, n, d_was_default)

    # shared dense/sparse/callable dispatch + the HIGHEST-precision
    # policy for dense matvecs (see qb.make_matvec — a reduced-precision
    # default product corrupts the Krylov basis, caught by the on-chip test)
    matvec = make_matvec(a)
    bb = b.astype(dtype) if dtype is not None else b
    q, aq = _truncated_arnoldi(matvec, bb, m, k)

    S = make_embedding(operator, d, n, state, vec_nnz=vec_nnz,
                       dtype=dtype or bb.dtype)
    sc = sketch_general(S, aq)                                # (d, m)
    sb = sketch_general(S, bb[:, None])[:, 0]                 # (d,)
    sb_norm = jnp.maximum(jnp.linalg.norm(sb),
                          jnp.finfo(sb.dtype).tiny)
    y = qr_clipped_lstsq(sc, sb)
    x = q @ y
    sr = sb - sc @ y
    require(refine >= 0, "refine must be >= 0")
    for _ in range(int(refine)):
        r = bb - matvec(x).astype(bb.dtype)
        sr = sketch_general(S, r[:, None])[:, 0]
        z = qr_clipped_lstsq(sc, sr)
        x = x + q @ z
        sr = sr - sc @ z
    res = jnp.linalg.norm(sr) / sb_norm
    return x, res, S.next_state
