"""Randomized Nyström approximation of PSD matrices.

Single-pass sketch-based low-rank eigendecomposition A ~= U diag(L) U^T
for symmetric positive semidefinite A, with the shifted-Cholesky
stabilization of Tropp–Yurtsever–Udell–Cevher (SIAM J. Matrix Anal.
2017, alg. 16 / Martinsson–Tropp 2020 alg. 14). Library-tier consumer
of the sketching core (the reference's examples tier builds the same
kind of pipelines on lskge3, e.g.
/root/reference/examples/sparse-low-rank-approx/svd_rank1_plus_noise.cc:217-300).

Accelerator notes: the (n, d) sketch Y = A @ S rides sketch_general's
dispatch; the d x d Cholesky + triangular solve are the only
non-GEMM-shaped steps and
run at O(d^2 n) <<< the sketch cost.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..base import require
from ..dense import DenseDist, DenseSkOp
from ..rng.state import RNGState
from ..skge import sketch_general
from .qb import _apply, _is_sparse, safe_svd


def nystrom(a, d: int, state: RNGState, dtype=jnp.float32, *,
            n: int = None) -> Tuple[jax.Array, jax.Array, RNGState]:
    """Rank-d Nyström approximation of PSD ``a`` (n x n).

    ``a`` may also be a callable ``a(X) -> A @ X`` (pass ``n``
    explicitly) — the sketch is the only access to A. Returns
    ``(u, lam, next_state)`` with ``u`` (n, d) orthonormal and
    ``lam`` (d,) nonnegative, so that A ~= u @ diag(lam) @ u.T. For A of
    exact rank r <= d the approximation is exact up to the stabilizing
    shift (~ eps * ||Y||_F).
    """
    if callable(a):
        require(n is not None, "callable a needs an explicit n")
    else:
        n = a.shape[0]
        require(a.shape[0] == a.shape[1], "nystrom needs a square PSD A")
    require(1 <= d <= n, "sketch size d must be in [1, n]")

    S = DenseSkOp(DenseDist(n, d), state, dtype=dtype)
    if callable(a):
        y = a(S.materialize())
    elif _is_sparse(a):
        y = _apply(a, S.materialize())
    else:
        y = sketch_general(S, a.astype(dtype), side="right", op_s="N")

    # Shifted Cholesky: nu ~ machine-eps scale of Y keeps the Gram
    # factor positive definite when A is numerically rank-deficient.
    eps = jnp.finfo(dtype).eps
    nu = eps * jnp.sqrt(jnp.float32(n)) * jnp.linalg.norm(y)
    omega = S.materialize()
    y_nu = y + nu * omega
    gram = omega.T @ y_nu                       # (d, d), symmetric PD
    gram = 0.5 * (gram + gram.T)
    c = jnp.linalg.cholesky(gram)
    # B = Y_nu C^{-T}  via triangular solve on the right
    b = jax.scipy.linalg.solve_triangular(c, y_nu.T, lower=True).T
    u, s, _ = safe_svd(b, full_matrices=False)
    lam = jnp.maximum(s * s - nu, 0.0)
    return u, lam, S.next_state


def nystrom_apply(u: jax.Array, lam: jax.Array, x: jax.Array) -> jax.Array:
    """(u diag(lam) u^T) @ x — apply the Nyström approximation."""
    return u @ (lam[:, None] * (u.T @ x))


def nystrom_pcg(a, b, state: RNGState, *, d: int, mu: float = 0.0,
                tol: float = None, maxiter: int = 500, dtype=None
                ) -> Tuple[jax.Array, jax.Array, RNGState]:
    """Solve the regularized PSD system ``(A + mu*I) x = b`` by CG with a
    randomized Nyström preconditioner (Frangella–Tropp–Udell 2021).

    The rank-``d`` Nyström sketch U diag(lam) U^T captures A's dominant
    eigenspace; the preconditioner

        P^{-1} v = U diag((lam_d + mu)/(lam + mu)) U^T v + (v - U U^T v)

    (``lam_d`` the smallest retained eigenvalue) compresses the spectrum
    of P^{-1}(A + mu I) to O(1) condition number once d exceeds A's
    effective dimension at level mu, so CG converges in a spectrum-
    independent number of iterations — the SPD counterpart of
    sketch_and_precondition. One sketch pass (d matvecs through A, rides
    the fused/SpMM dispatch) buys the whole preconditioner; each CG step
    is one A-matvec plus two skinny (n, d) products.

    ``a`` is a dense array, sparse container (COO/CSR/CSC), or a callable
    ``a(X) -> A @ X``; ``b`` is (n,) or (n, k) (block RHS, per-column
    steps like cgls). Returns ``(x, iterations, next_state)``.
    """
    vec = b.ndim == 1
    bb = b[:, None] if vec else b
    n = bb.shape[0]
    require(1 <= d <= n, "sketch size d must be in [1, n]")
    matvec = a if callable(a) else (lambda x: _apply(a, x))
    u, lam, nxt = nystrom(a, d, state,
                          dtype or bb.dtype, n=n)
    lam = lam.astype(bb.dtype)
    u = u.astype(bb.dtype)
    # Effective-rank form of the FTU scaling: when mu == 0 and the
    # Nystrom tail clamps to (near) zero (numerically rank-deficient A),
    # the raw ratio (lam_d + mu)/(lam + mu) with lam_d = lam[-1] is 0/0.
    # Drop directions below eps * lam_reg[0] (junk at rounding level)
    # and take lam_d as the smallest KEPT regularized eigenvalue, so the
    # preconditioned head spectrum is exactly uniform at lam_d; dropped
    # directions get scale 1 (identity). Flooring at lam_reg[-1] instead
    # (the round-2 form) collapses the head to ~eps*lam[0] — barely above
    # the junk tail — and CG stagnates (regression test:
    # test_nystrom_pcg_rank_deficient_mu_zero).
    lam_reg = lam + mu
    eps = jnp.finfo(bb.dtype).eps
    cutoff = jnp.maximum(eps * lam_reg[0], jnp.finfo(bb.dtype).tiny)
    kept = lam_reg > cutoff
    lam_d = jnp.min(jnp.where(kept, lam_reg, jnp.inf))
    lam_d = jnp.where(jnp.isfinite(lam_d), lam_d, lam_reg.dtype.type(1.0))
    safe = jnp.maximum(lam_reg, cutoff)
    scale = jnp.where(kept, lam_d / safe, 1.0)[:, None]

    def pinv(v):
        w = u.T @ v                                   # (d, k)
        return u @ (scale * w) + (v - u @ w)

    op = (lambda x: matvec(x) + mu * x) if mu else matvec
    if tol is None:
        tol = 100.0 * float(jnp.finfo(bb.dtype).eps)
    # Warm start with the direct Nystrom head-solve
    # x0 = U diag(1/lam_reg) U^T b (captured directions only). In the
    # degenerate regime — mu == 0 and the tail clamped to zero with b in
    # range(A) — this IS the solution and CG exits immediately; in the
    # regular regime it is one free application of the approximate
    # inverse (the sketch is already paid for).
    inv_head = jnp.where(kept, 1.0 / safe, 0.0)[:, None]
    x0 = u @ (inv_head * (u.T @ bb))
    from .lstsq import _pcg
    x, k = _pcg(op, bb, pinv=pinv, x0=x0, tol=tol, maxiter=maxiter)
    return (x[:, 0] if vec else x), k, nxt
