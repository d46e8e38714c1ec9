"""Randomized eigendecomposition of symmetric (possibly indefinite)
matrices via Rayleigh–Ritz on a sketched range basis.

Completes the eigensolver family next to the PSD-only Nyström tier
(nystrom.py): for symmetric A with a mixed-sign spectrum, range(A) is
spanned by the dominant-|lambda| eigenvectors, so the QB rangefinder
basis Q captures them and the k x k projection T = Q^T A Q delivers
signed Ritz values (HMT 2011, alg. 5.3 / Martinsson–Tropp 2020 §11.7).
Same consumer shape as the reference's examples tier pipelines
(/root/reference/examples/sparse-low-rank-approx/svd_rank1_plus_noise.cc:217-300),
upgraded from SVD to a one-sided symmetric factorization.

Accelerator notes: the rangefinder rides sketch_general's dispatch;
the only non-GEMM-shaped steps are the k x k eigh and the final thin
products.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..base import require
from ..rng.state import RNGState
from .qb import _apply, rangefinder


def rand_eigh(a, k: int, state: RNGState, power_iters: int = 2,
              dtype=jnp.float32, operator: str = "gaussian"
              ) -> Tuple[jax.Array, jax.Array]:
    """Rank-k randomized symmetric eigendecomposition:
    ``A ~= u @ diag(w) @ u.T`` with signed eigenvalues.

    ``a`` is symmetric (n, n), dense or sparse (COO/CSR/CSC); symmetry is
    assumed, not checked (use util.require_symmetric beforehand if
    unsure). Returns ``(w, u)`` with ``w`` (k,) ascending (eigh
    convention) and ``u`` (n, k) orthonormal. For A of exact rank
    r <= k the factorization is exact; in general the Ritz values
    approximate the k dominant-|lambda| eigenvalues with rangefinder
    accuracy. ``operator`` picks the rangefinder embedding family
    ('gaussian' | 'saso' | 'srht', dense data only for the latter two).
    """
    n, n2 = a.shape
    require(n == n2, "rand_eigh needs a square symmetric A")
    require(1 <= k <= n, "rank must be in [1, n]")
    q = rangefinder(a, k, state, power_iters, dtype, operator)
    aq = _apply(a, q)                                  # (n, k)
    t = jnp.matmul(q.T, aq, preferred_element_type=dtype)
    t = 0.5 * (t + t.T)                                # Rayleigh quotient
    w, v = jnp.linalg.eigh(t)
    u = jnp.matmul(q, v, preferred_element_type=dtype)
    return w, u


def rand_geigh(a, b, k: int, state: RNGState, power_iters: int = 2,
               dtype=jnp.float32, operator: str = "gaussian"
               ) -> Tuple[jax.Array, jax.Array]:
    """Rank-k randomized GENERALIZED symmetric-definite eigensolver:
    the k dominant-|theta| pairs of ``A x = theta B x`` with A symmetric
    and B symmetric positive definite (both dense (n, n)).

    Fully on-device and jittable — this is the generalized counterpart
    the host-eig boundary note in docs/linalg.md points to: XLA has no
    generalized eig, but the symmetric-DEFINITE pencil reduces exactly
    to a standard symmetric problem by Cholesky whitening
    (Golub & Van Loan §8.7): with B = L L^T,

        C = L^-1 A L^-T,   C y = theta y,   x = L^-T y,

    so the randomized Rayleigh-Ritz machinery of rand_eigh applies to C
    unchanged. C is never formed: every product the rangefinder needs is
    ``C @ X = L^-1 (A (L^-T X))`` — two triangular solves against the
    k-column block plus one A-apply, O(n^2 k) per pass instead of the
    O(n^3) explicit whitening.
    ``operator`` is accepted for signature parity with rand_eigh but
    only 'gaussian' is supported (structured embeddings need a
    materialized operand).

    Returns ``(theta, x)`` with ``theta`` (k,) ascending and ``x``
    (n, k) B-orthonormal (``x.T @ B @ x == I`` — the natural
    normalization for a definite pencil; it reduces to plain
    orthonormality at B = I, where the function degenerates to
    rand_eigh). For a pencil whose whitened form has exact rank
    r <= k the factorization is exact. Reference: ABSENT (RandBLAS has
    no eigensolvers; this extends the examples-tier posture the same
    way rand_eigh does)."""
    from .distributed import cholqr
    from ..dense import DenseDist, DenseSkOp

    n, n2 = a.shape
    require(n == n2, "rand_geigh needs a square symmetric A")
    require(b.shape == (n, n), "B must match A's shape")
    require(1 <= k <= n, "rank must be in [1, n]")
    require(operator == "gaussian",
            "rand_geigh supports only the 'gaussian' probe family "
            "(the whitened operator is implicit)")
    ell = jnp.linalg.cholesky(b.astype(dtype))         # B = L L^T

    def cmat(x):                                       # C @ X, (n, k)
        x = jax.scipy.linalg.solve_triangular(ell.T, x, lower=False)
        x = _apply(a, x).astype(dtype)
        return jax.scipy.linalg.solve_triangular(ell, x, lower=True)

    def orth(y):
        q, _ = cholqr(y)
        return q

    probe = DenseSkOp(DenseDist(k, n), state, dtype=dtype)
    y = cmat(probe.materialize().T)                    # C @ Omega
    for _ in range(power_iters):
        # the rangefinder's per-pass schedule specialized to C^T == C:
        # stabilize between every apply
        y = cmat(orth(cmat(orth(y))))
    q = orth(y)
    cq = cmat(q)
    t = jnp.matmul(q.T, cq, preferred_element_type=dtype)
    t = 0.5 * (t + t.T)                                # Rayleigh quotient
    w, v = jnp.linalg.eigh(t)
    u = jnp.matmul(q, v, preferred_element_type=dtype)
    x = jax.scipy.linalg.solve_triangular(ell.T, u, lower=False)
    return w, x
