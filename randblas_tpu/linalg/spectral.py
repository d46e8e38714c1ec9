"""Randomized spectral estimation: power method, extremal eigenvalues,
spectral norm.

Port of the reference's power-method machinery, which lives
in its TEST infrastructure (/root/reference/test/handrolled_lapack.hh:
214-231 required_powermethod_iters, :233-252 power_method, :254-303
exeigs_powermethod) and backs the subspace-distortion statistical tier
(test_distortion.cc:49-116). Here it is a library: the iteration count
comes from the same Kuczynski-Wozniakowski-style bounds, the start
vector is a counter-addressed Gaussian probe (seed-chained like every
estimator in this tier), and the loop is a lax.fori_loop of
matvec-shaped products — dense, sparse, or callable operators.

lambda_min: for DENSE operators this matches the reference
(exeigs_powermethod explicitly inverts A via Cholesky and powers
inv(A), giving RELATIVE accuracy ~tol on lambda_min itself). For
implicit/sparse operators — which the reference does not support at
all — no factorization is available, so lambda_min comes from powering
the PSD complement (sigma*I - A) with sigma slightly above the
lambda_max estimate. The complement's convergence is relative to ITS
dominant eigenvalue ~lambda_max, so that path's lambda_min error is
ABSOLUTE, ~tol * lambda_max — fine for subspace-distortion checks
(lambda_min ~ lambda_max by construction), useless for condition
numbers of ill-conditioned operators; the docstring of extremal_eigs
states which path a given input takes. The reference's own comments
(:254-262) discuss this family of trade-offs.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from ..base import require
from ..dense import DenseDist, DenseSkOp
from ..rng.state import RNGState
from .qb import _apply, _is_sparse, _mm_precise, make_matvec, safe_svd


def required_power_iters(n: int, p_fail: float, tol: float) -> int:
    """Iterations for the power method on an n x n PSD matrix to reach
    relative accuracy ``tol`` with failure probability ``p_fail``
    (Gaussian start): max of the expectation bound and the min of two
    probability bounds (handrolled_lapack.hh:214-231).

    Intentional divergence: the C++'s probability bounds truncate the
    log to an integer BEFORE dividing by log(1/(1-tol)) (the int64_t
    cast binds to std::log), losing up to 1/t1 iterations of the bound.
    This port divides first and truncates last — the mathematically
    stated bound — so it returns slightly MORE iterations (safe side);
    e.g. n=1000, tol=1e-2, p_fail=1e-6: ~1721 here vs ~1691 there.
    """
    require(0 < tol < 1 and 0 < p_fail < 1, "need 0 < tol, p_fail < 1")
    expectation_bound = math.ceil(
        (1.0 + math.log(math.sqrt(math.pi * n))) / tol)
    t0 = 1.0 - tol
    t1 = math.log(1.0 / t0)
    t2 = tol * p_fail * p_fail
    prob1 = int(math.log(math.e + 0.27 * t0 * t1 / t2) / t1)
    prob2 = int(math.log(math.sqrt(n) / p_fail) / t1)
    return max(expectation_bound, min(prob1, prob2))


def _probe(n: int, state: RNGState, dtype) -> Tuple[jax.Array, RNGState]:
    """Counter-addressed Gaussian start vector (n,) + chained state."""
    S = DenseSkOp(DenseDist(1, n), state, dtype=dtype)
    return S.materialize()[0], S.next_state


def power_method(matvec: Callable, n: int, state: RNGState, *,
                 tol: float = 1e-2, p_fail: float = 1e-6,
                 iters: int = None, dtype=jnp.float32
                 ) -> Tuple[jax.Array, jax.Array, RNGState]:
    """Dominant eigenpair of the PSD operator given by ``matvec``
    (n -> n), via ``iters`` power steps (default from
    required_power_iters). Returns ``(lam, v, next_state)`` with ``lam``
    the Rayleigh quotient and ``v`` the unit iterate.
    """
    if iters is None:
        iters = required_power_iters(n, p_fail, tol)
    v0, nxt = _probe(n, state, dtype)
    v0 = v0 / jnp.linalg.norm(v0)

    def body(_, v):
        w = matvec(v)
        return w / jnp.maximum(jnp.linalg.norm(w),
                               jnp.finfo(dtype).tiny)

    v = jax.lax.fori_loop(0, iters, body, v0)
    lam = jnp.vdot(v, matvec(v))
    return lam, v, nxt


def extremal_eigs(a, state: RNGState, *, tol: float = 1e-2,
                  p_fail: float = 1e-6, iters: int = None,
                  dtype=jnp.float32, n: int = None
                  ) -> Tuple[jax.Array, jax.Array, RNGState]:
    """(lambda_min, lambda_max, next_state) of the PSD operator ``a``
    (dense array, sparse container, or callable matvec with explicit
    ``n``) — the library form of exeigs_powermethod
    (handrolled_lapack.hh:264-303).

    Accuracy of lambda_min depends on the input form. A dense POSITIVE
    DEFINITE array takes the reference's path: one Cholesky + explicit
    inverse, then the power method on inv(A) — relative error ~tol on
    lambda_min regardless of conditioning. Sparse containers and
    callables (no factorization available) power the shifted complement
    (sigma*I - A), whose lambda_min error is ABSOLUTE, ~tol*lambda_max;
    do not use those forms for condition numbers of ill-conditioned
    operators (module docstring).
    """
    if callable(a):
        require(n is not None, "callable a needs an explicit n")
        matvec = a
    else:
        require(a.shape[0] == a.shape[1], "extremal_eigs needs square A")
        n = a.shape[0]
        matvec = lambda v: _apply(a, v[:, None])[:, 0]
    lam_max, _, st = power_method(matvec, n, state, tol=tol,
                                  p_fail=p_fail, iters=iters, dtype=dtype)
    if not callable(a) and not _is_sparse(a):
        # Reference parity (handrolled_lapack.hh:275-303): invert A once
        # through its Cholesky factor, power inv(A), invert the estimate.
        chol = jnp.linalg.cholesky(a.astype(dtype))
        if bool(jnp.all(jnp.isfinite(chol))):
            inv_a = jax.scipy.linalg.cho_solve((chol, True),
                                               jnp.eye(n, dtype=dtype))
            inv_a = 0.5 * (inv_a + inv_a.T)
            mu, _, nxt = power_method(
                lambda v: _apply(inv_a, v[:, None])[:, 0], n, st,
                tol=tol, p_fail=p_fail, iters=iters, dtype=dtype)
            lam_min = 1.0 / jnp.maximum(mu, jnp.finfo(dtype).tiny)
            return lam_min, lam_max, nxt
        # singular/indefinite-at-rounding PSD (rank-deficient Gram
        # matrices are a legitimate input per the PSD contract): the
        # Cholesky is NaN, so fall through to the factorization-free
        # complement path, which returns a finite lam_min ~ 0 with
        # absolute accuracy ~tol*lam_max — never a silent NaN.
    sigma = lam_max * (1.0 + tol)
    comp = lambda v: sigma * v - matvec(v)
    mu, _, nxt = power_method(comp, n, st, tol=tol, p_fail=p_fail,
                              iters=iters, dtype=dtype)
    lam_min = jnp.maximum(sigma - mu, 0.0)
    return lam_min, lam_max, nxt


def spectral_norm(a, state: RNGState, *, tol: float = 1e-2,
                  p_fail: float = 1e-6, iters: int = None,
                  dtype=jnp.float32) -> Tuple[jax.Array, RNGState]:
    """sigma_max(A) for rectangular A (dense or sparse), via the power
    method on the PSD Gram operator A^T A. Returns
    ``(sigma_max, next_state)``."""
    from .qb import _apply_t
    m, n = a.shape
    gram = lambda v: _apply_t(a, _apply(a, v[:, None]))[:, 0]
    lam, _, nxt = power_method(gram, n, state, tol=tol, p_fail=p_fail,
                               iters=iters, dtype=dtype)
    return jnp.sqrt(jnp.maximum(lam, 0.0)), nxt


def sketched_eigs(a, k: int, state: RNGState, *, basis: int = None,
                  trunc: int = 4, d: int = None, operator: str = "saso",
                  vec_nnz: int = 8, which: str = "LM", sym: bool = False,
                  n: int = None, dtype=jnp.float32):
    """Approximate eigenpairs of square A by sketched Rayleigh–Ritz
    (Nakatsukasa–Tropp 2021, alg. 2): an m-dimensional k-truncated
    Arnoldi basis Q from a counter-addressed Gaussian start vector,
    whitened through a d ~ 2m sketching operator, then Ritz pairs of
    pinv(S Q) (S A Q) — full-Arnoldi quality at truncated-Arnoldi cost.

    ``a`` is (n, n) dense, sparse, or a callable matvec (pass ``n``);
    ``basis`` defaults to ``min(n, max(4k, 2k + 10))``; ``which``
    selects 'LM' (largest magnitude) or 'LR' (largest real part).

    ``sym=False``: the m x m Ritz eigenproblem is NONSYMMETRIC and runs
    on the host (np.linalg.eig — XLA's general eig is CPU-only; the
    matrix is tiny). Returns complex ``(theta (k,), x (n, k), resid (k,),
    next_state)`` with ``resid`` the sketched relative residuals
    ||S(A x - theta x)|| / (|theta| ||S x||).

    ``sym=True`` (symmetric A): DIRECT Rayleigh–Ritz on the
    SVD-orthonormalized basis — on-device eigh, real output, whole
    function jittable, no sketch consumed (next_state advances only by
    the start-vector probe). The sketched pencil is deliberately NOT
    symmetrized: (S Qtil)^T (S A Qtil) is symmetric only up to the
    embedding distortion, which is O(1) at d ~ 2m (measured: symmetrized
    Ritz values off by 10-80%), while the un-sketched U^T A U is exactly
    symmetric and the pencil eig (sym=False) preserves converged Ritz
    pairs under ANY injective embedding. The indefinite counterpart of
    rand_eigh's SPD-oriented pipeline.
    """
    from .sgmres import _truncated_arnoldi
    from ..skge import sketch_general
    from .embed import make_embedding
    if callable(a):
        require(n is not None, "callable a needs an explicit n")
    else:
        require(a.shape[0] == a.shape[1], "sketched_eigs needs square A")
        n = a.shape[0]
    m = min(n, max(4 * k, 2 * k + 10)) if basis is None else min(basis, n)
    require(1 <= k <= m, "need 1 <= k <= basis")
    d_was_default = d is None
    d = min(n, 2 * m + 8) if d is None else d
    require(d >= m, "embedding dimension d must be >= basis")
    if not sym:
        from .sgmres import _warn_thin_embedding
        _warn_thin_embedding(d, m, n, d_was_default)

    # shared dense/sparse/callable dispatch + the HIGHEST-precision
    # policy for dense matvecs (qb.make_matvec; the Arnoldi body casts
    # to the basis dtype)
    matvec = make_matvec(a)
    v0, st = _probe(n, state, dtype)
    q, aq = _truncated_arnoldi(matvec, v0, m, min(trunc, m))

    if sym:
        # Direct Rayleigh–Ritz: q = U S V^T; the orthonormal basis is U
        # and A U = aq (V S^+) EXACTLY (aq = A q by construction), so
        # h = U^T A U needs no extra matvecs. Clip at sqrt(eps)
        # relative: the 1/s amplification of rounding noise in aq V S^+
        # is then bounded by ~sqrt(eps), and the dropped directions are
        # the numerically repeated ones a truncated basis develops.
        u, s, vt = safe_svd(q, full_matrices=False)
        cutoff = jnp.sqrt(jnp.finfo(dtype).eps) * jnp.maximum(
            s[0], jnp.finfo(dtype).tiny)
        keep = s > cutoff
        s_inv = jnp.where(keep, 1.0 / jnp.maximum(s, cutoff), 0.0)
        # thin products at certificate precision (_mm_precise): their
        # reduced-precision default rounding would land directly on h
        # and the Ritz pairs, wasting the HIGHEST-precision matvecs
        # above (review find)
        au = _mm_precise(aq, vt.T * s_inv[None, :])            # A U, (n, m)
        h = _mm_precise(u.T, au)
        h = jnp.where(keep[:, None] & keep[None, :],
                      0.5 * (h + h.T), 0.0)
        theta_all, w_all = jnp.linalg.eigh(h)
        order = jnp.argsort(-jnp.abs(theta_all) if which == "LM"
                            else -theta_all)
        sel = order[:k]
        theta = theta_all[sel]
        w = w_all[:, sel]
        x = _mm_precise(u, w)
        num = jnp.linalg.norm(_mm_precise(au, w) - x * theta[None, :],
                              axis=0)
        den = jnp.maximum(jnp.abs(theta), jnp.finfo(dtype).tiny)
        return theta, x, num / den, st

    S = make_embedding(operator, d, n, st, vec_nnz=vec_nnz, dtype=dtype)
    sq = sketch_general(S, q)                                  # (d, m)
    saq = sketch_general(S, aq)                                # (d, m)
    nxt = S.next_state
    # Whitened pencil: with sq = U S V^T (clipped SVD — breakdown
    # columns of a short Krylov space make sq exactly rank-deficient),
    # the substitution y = (V S^+) z turns the pencil saq y = theta sq y
    # into M_w z = theta z with M_w = U^T saq (V S^+). Converged Ritz
    # pairs of the subspace are exact eigenpairs of the pencil for ANY
    # injective S, so eig(M_w) recovers them regardless of the
    # embedding distortion (unlike any symmetrization — see the sym
    # branch note above).
    u, s, vt = safe_svd(sq, full_matrices=False)
    cutoff = jnp.finfo(dtype).eps * m * jnp.maximum(
        s[0], jnp.finfo(dtype).tiny)
    s_inv = jnp.where(s > cutoff, 1.0 / jnp.maximum(s, cutoff), 0.0)
    white = vt.T * s_inv[None, :]                              # V S^+
    mw = u.T @ (saq @ white)                                   # (m, m)

    import numpy as np
    mw_np = np.asarray(jax.device_get(mw), dtype=np.float64)
    theta_all, w_all = np.linalg.eig(mw_np)
    order = np.argsort(-np.abs(theta_all) if which == "LM"
                       else -theta_all.real)
    sel = order[:k]
    theta = theta_all[sel]
    y = np.asarray(jax.device_get(white), dtype=np.float64) @ w_all[:, sel]
    q_np = np.asarray(jax.device_get(q), dtype=np.float64)
    sq_np = np.asarray(jax.device_get(sq), dtype=np.float64)
    saq_np = np.asarray(jax.device_get(saq), dtype=np.float64)
    x = q_np @ y
    x = x / np.maximum(np.linalg.norm(x, axis=0, keepdims=True),
                       np.finfo(np.float64).tiny)
    num = np.linalg.norm(saq_np @ y - (sq_np @ y) * theta[None, :], axis=0)
    den = np.maximum(np.abs(theta) * np.linalg.norm(sq_np @ y, axis=0),
                     np.finfo(np.float64).tiny)
    return (jnp.asarray(theta), jnp.asarray(x), jnp.asarray(num / den), nxt)
