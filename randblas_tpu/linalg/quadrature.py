"""Stochastic Lanczos quadrature: tr(f(A)) for spectral functions.

Ubaru-Chen-Saad 2017: for symmetric A and a Gaussian probe v, the
bilinear form v^T f(A) v equals ||v||^2 * e1^T f(T) e1 with T the
Lanczos tridiagonal of A started at v/||v|| — a Gauss quadrature rule
whose nodes/weights come from eigh of the tiny (steps x steps) T.
Averaging over probes gives tr(f(A)) with Hutchinson-type concentration
but FAR better per-probe accuracy than f-free estimators whenever f is
smooth (log, exp, sqrt, powers): quadrature error decays geometrically
in the Lanczos depth.

This is the missing spectral-function member of the trace tier
(hutchinson/hutchpp estimate tr(A) itself; logdet = tr(log(A)) needs
quadrature). The reference has no estimator tier at all — its users
build exactly these pipelines on the sketching primitives.

Accelerator notes: the Lanczos recurrence is a lax.scan of matvecs
(rides qb._apply's dispatch incl. the f64 routing); all probes run the
recurrence as ONE blocked matvec per step (one (n, probes) GEMM where a
per-probe loop would issue GEMVs); full reorthogonalization against the
stored basis is O(n * steps^2 * probes) GEMM work at Precision.HIGHEST — negligible next to the matvecs, and
without it f32 Lanczos loses orthogonality by step ~20 and the
quadrature nodes go complex-ghost.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from ..base import require
from ..dense import DenseDist, DenseSkOp
from ..rng.state import RNGState
from .qb import _apply, _is_sparse, _mm_precise


def _block_lanczos_tridiag(matvec, v0: jax.Array, steps: int):
    """Run `steps` Lanczos iterations for EVERY column of ``v0`` (n, p)
    simultaneously (p independent single-vector recurrences, batched as
    block matvecs). Full reorthogonalization per probe against its own
    stored basis. Returns (alphas (p, steps), betas (p, steps-1))."""
    n, p = v0.shape
    nrm = jnp.linalg.norm(v0, axis=0)
    q = v0 / jnp.maximum(nrm, jnp.finfo(v0.dtype).tiny)

    basis0 = jnp.zeros((steps, n, p), v0.dtype)

    def step(carry, i):
        q_prev, q_cur, beta_prev, basis = carry
        # cast defensively: a user-supplied matvec may compute in a
        # wider dtype than the probes (the recurrence must stay one type)
        w = matvec(q_cur).astype(v0.dtype)             # (n, p)
        alpha = jnp.sum(q_cur * w, axis=0)             # (p,)
        w = w - alpha * q_cur - beta_prev * q_prev
        basis = basis.at[i].set(q_cur)
        # full reorthogonalization (two passes) against each probe's own
        # basis: coeffs[k, j] = <basis[k,:,j], w[:,j]>
        for _ in range(2):
            coeffs = jnp.einsum("knp,np->kp", basis, w,
                                precision=jax.lax.Precision.HIGHEST)
            w = w - jnp.einsum("knp,kp->np", basis, coeffs,
                               precision=jax.lax.Precision.HIGHEST)
        beta = jnp.linalg.norm(w, axis=0)
        q_next = w / jnp.maximum(beta, jnp.finfo(w.dtype).tiny)
        return (q_cur, q_next, beta, basis), (alpha, beta)

    init = (jnp.zeros_like(q), q, jnp.zeros((p,), v0.dtype), basis0)
    (_, _, _, basis), (alphas, betas) = jax.lax.scan(
        step, init, jnp.arange(steps))
    # alphas: (steps, p) -> (p, steps); betas likewise, last beta unused
    return alphas.T, betas[:-1].T, nrm, basis


def slq(a, f: Callable, state: RNGState, *, probes: int = 8,
        steps: int = 30, dtype=jnp.float32, n: int = None
        ) -> Tuple[jax.Array, RNGState]:
    """Estimate ``tr(f(A))`` for symmetric ``a`` by stochastic Lanczos
    quadrature. ``f`` is applied elementwise to quadrature nodes (use
    ``jnp.log``, ``jnp.exp``, ``jnp.sqrt``, lambdas...). ``a`` is a
    dense array, sparse container, or callable block matvec (pass ``n``).
    ``steps`` is the Lanczos/quadrature depth (error decays
    geometrically in it for f analytic on the spectrum's interval);
    ``probes`` Gaussian probes control the Hutchinson-type variance.
    Returns ``(estimate, next_state)``.
    """
    if callable(a) and not hasattr(a, "shape"):
        require(n is not None, "callable a needs an explicit n")
        matvec = a
    else:
        require(a.shape[0] == a.shape[1], "slq needs a square symmetric A")
        n = a.shape[0]
        matvec = lambda x: _apply(a, x)
    require(probes >= 1, "probes must be >= 1")
    require(1 <= steps <= n, "steps must be in [1, n]")

    S = DenseSkOp(DenseDist(n, probes), state, dtype=dtype)
    v0 = S.materialize()                               # (n, probes)
    alphas, betas, nrm, _ = _block_lanczos_tridiag(matvec, v0, steps)

    def one_quadrature(alpha, beta):
        t = jnp.diag(alpha) + jnp.diag(beta, 1) + jnp.diag(beta, -1)
        theta, vecs = jnp.linalg.eigh(t)
        tau2 = vecs[0, :] ** 2                          # e1 weights
        # Lanczos breakdown (Krylov space exhausted before `steps`)
        # parks spurious nodes at 0 with ~0 weight; f may be singular
        # there (log), and -inf * 0 = nan — mask BEFORE multiplying.
        live = tau2 > jnp.finfo(tau2.dtype).eps
        vals = jnp.where(live, f(jnp.where(live, theta, 1.0)), 0.0)
        return jnp.sum(tau2 * vals)

    quads = jax.vmap(one_quadrature)(alphas, betas)    # (probes,)
    est = jnp.mean(nrm.astype(quads.dtype) ** 2 * quads)
    return est, S.next_state


def logdet(a, state: RNGState, *, probes: int = 8, steps: int = 30,
           dtype=jnp.float32, n: int = None
           ) -> Tuple[jax.Array, RNGState]:
    """``log det(A)`` for symmetric POSITIVE DEFINITE ``a`` = tr(log A)
    by :func:`slq`. The classic SLQ application (Ubaru-Chen-Saad 2017
    sec. 1): exact logdet costs a Cholesky (O(n^3), dense only); this
    costs probes*steps matvecs and works for sparse/implicit operators.
    Accuracy degrades as cond(A) grows (log is singular at 0 — raise
    ``steps`` for ill-conditioned A). Returns ``(estimate, next_state)``.
    """
    return slq(a, jnp.log, state, probes=probes, steps=steps,
               dtype=dtype, n=n)


def lanczos_fn_apply(a, f: Callable, b, *, steps: int = 30,
                     dtype=None, n: int = None) -> jax.Array:
    """Apply a matrix function to vectors: ``f(A) @ b`` for symmetric
    ``a`` without ever forming f(A), via the Lanczos relation

        f(A) b ~= ||b|| * V f(T) e1

    with (V, T) the Lanczos basis/tridiagonal started at b/||b||
    (Higham ch. 13 / Saad 1992) — exp(t A) @ v, A^{-1/2} @ b,
    log(A) @ b... at the cost of ``steps`` matvecs per column, with the
    same geometric-in-steps accuracy as slq (it is the same machinery;
    full reorthogonalization keeps f32 honest). ``b`` is (n,) or (n, k)
    — columns run batched as block matvecs. ``f`` maps eigenvalues
    elementwise. The reference has no matrix-function tier at all.
    """
    vec = b.ndim == 1
    bb = b[:, None] if vec else b
    if callable(a) and not hasattr(a, "shape"):
        require(n is not None, "callable a needs an explicit n")
        matvec = a
    else:
        require(a.shape[0] == a.shape[1],
                "lanczos_fn_apply needs a square symmetric A")
        n = a.shape[0]
        matvec = lambda x: _apply(a, x)
    require(bb.shape[0] == n, "b must have A's dimension")
    require(1 <= steps <= n, "steps must be in [1, n]")
    if dtype is not None:
        bb = bb.astype(dtype)
    alphas, betas, nrm, basis = _block_lanczos_tridiag(matvec, bb, steps)

    def one_apply(alpha, beta):
        t = jnp.diag(alpha) + jnp.diag(beta, 1) + jnp.diag(beta, -1)
        theta, vecs = jnp.linalg.eigh(t)
        live = jnp.abs(vecs[0, :]) > jnp.finfo(theta.dtype).eps
        vals = jnp.where(live, f(jnp.where(live, theta, 1.0)), 0.0)
        return vecs @ (vals * vecs[0, :])              # f(T) e1, (steps,)

    ft_e1 = jax.vmap(one_apply)(alphas, betas)          # (p, steps)
    # x_j = ||b_j|| * sum_k basis[k, :, j] * ft_e1[j, k]
    x = jnp.einsum("knp,pk->np", basis, ft_e1,
                   precision=jax.lax.Precision.HIGHEST)
    x = x * nrm[None, :].astype(x.dtype)
    return x[:, 0] if vec else x
