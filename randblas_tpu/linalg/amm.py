"""Monte-Carlo approximate matrix multiplication (BasicMatrixMultiply).

Drineas–Kannan–Mahoney 2006 (SIAM J. Comput., "Fast Monte Carlo
algorithms for matrices I"): approximate ``A @ B`` by sampling ``s``
index pairs (column i of A, row i of B) with the variance-optimal
probabilities

    p_i = ||A[:, i]|| * ||B[i, :]|| / sum_j ||A[:, j]|| * ||B[j, :]||

and averaging the rescaled outer products — equivalently one (m, s) x
(s, p) GEMM of the gathered, 1/sqrt(s * p_i)-scaled panels. The
estimator is unbiased and satisfies

    E ||A B - amm||_F <= ||A||_F ||B||_F / sqrt(s).

This is the classic RandNLA primitive the reference's sampling
machinery exists to serve: the index stream rides the counter-based
CDF sampler (util.weights_to_cdf + util.sample_indices_iid — the
reference-exact streams of util.hh:285-306), so results are
reproducible and the state chains like every other consumer. Reference:
ABSENT as an algorithm (RandBLAS ships the sampler, not the consumer).

Accelerator notes: the norms, CDF, gathers and the final GEMM are all
one fused XLA graph — jittable end to end; the contraction is one
(m, s) x (s, p) GEMM. Use when n is huge and a full pass is affordable
but the full O(m n p) product is not (s << n).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..base import require
from ..rng.state import RNGState
from ..util import sample_indices_iid, weights_to_cdf


def amm(a: jax.Array, b: jax.Array, s: int, state: RNGState,
        ) -> Tuple[jax.Array, RNGState]:
    """Approximate ``A @ B`` from ``s`` sampled outer products.

    ``a`` (m, n) and ``b`` (n, p) dense; ``s`` is the sample count
    (error ~ ||A||_F ||B||_F / sqrt(s)). Returns
    ``(approx (m, p), next_state)``. Sampling uses the optimal
    row-column norm-product probabilities; zero-norm indices get zero
    probability (they contribute nothing to A B). Unbiased: averaging
    independent calls (chaining ``next_state``) converges to A @ B.
    """
    require(a.ndim == 2 and b.ndim == 2, "amm takes matrices")
    require(a.shape[1] == b.shape[0],
            "inner dimensions must match (A (m, n), B (n, p))")
    require(s >= 1, "need at least one sample")
    na = jnp.linalg.norm(a, axis=0)                    # (n,)
    nb = jnp.linalg.norm(b, axis=1)                    # (n,)
    w = na * nb
    # degenerate guard on total == 0 EXACTLY: if A B == 0, any
    # distribution gives the correct zero estimate — use uniform. The
    # guard must test == 0, not > 0, so a NaN total (NaN input) takes
    # the sampled branch and PROPAGATES instead of masquerading as an
    # exact zero product (review find, round 4).
    total = jnp.sum(w)
    degenerate = total == 0
    n = w.shape[0]
    safe_w = jnp.where(degenerate, jnp.ones_like(w), w)
    cdf = weights_to_cdf(safe_w)
    idx, next_state = sample_indices_iid(cdf, s, state)
    p_i = safe_w[idx] / jnp.where(degenerate, jnp.asarray(n, w.dtype),
                                  total)
    scale = 1.0 / jnp.sqrt(s * jnp.maximum(p_i,
                                           jnp.finfo(p_i.dtype).tiny))
    left = a[:, idx] * scale[None, :]                  # (m, s)
    right = b[idx, :] * scale[:, None]                 # (s, p)
    approx = jnp.matmul(left, right,
                        preferred_element_type=a.dtype)
    return jnp.where(degenerate, jnp.zeros_like(approx),
                     approx), next_state


def sample_lsq(a: jax.Array, b: jax.Array, s: int, state: RNGState, *,
               scores: jax.Array = None, lam: float = 0.5,
               ) -> Tuple[jax.Array, RNGState]:
    """Leverage-score ROW-SAMPLING least squares: an approximate
    ``argmin ||A x - b||`` from ``s`` sampled rows (DMM06 / Mahoney
    2011 §4 — the sampling sibling of the projection-based
    sketch_and_solve_lsq).

    Rows are drawn with probabilities mixing the (estimated) leverage
    scores with uniform, ``p_i = lam * l_i / n + (1 - lam) / m``
    (the standard defense against under-estimated scores), rescaled by
    ``1 / sqrt(s * p_i)``, and the (s, n) subproblem is solved by the
    damped QR (qb.qr_clipped_lstsq). With s = O(n log n / eps) the solution is
    (1 + eps)-quasi-optimal. ``scores`` lets callers reuse precomputed
    leverage scores (e.g. exact_leverage_scores, or across many right-
    hand sides); otherwise they are estimated with leverage_scores
    (one sketched pass over A, state-chained).

    Returns ``(x, next_state)``. Prefer sketch_and_solve_lsq /
    sketch_and_precondition when A fits a full sketching pass — row
    sampling's edge is when only selected ROWS of A are affordable to
    touch after the (cheap, sketched) score pass, or when scores are
    already known."""
    require(a.ndim == 2, "sample_lsq takes a matrix A")
    m, n = a.shape
    require(m >= n, "sample_lsq expects a tall system (m >= n)")
    require(s >= n, "need at least n sampled rows")
    require(b.shape[0] == m, "b must have A's row count")
    require(0.0 <= lam <= 1.0, "lam must be in [0, 1]")
    from .leverage import leverage_scores
    if lam == 0.0:
        # pure-uniform baseline: the score pass's output would be
        # multiplied by zero — skip the whole estimation (and its RNG
        # consumption) rather than discarding it (review find, round 4)
        scores = jnp.zeros((m,), jnp.float32)
    elif scores is None:
        scores, state = leverage_scores(a, state)
    stotal = jnp.sum(scores)
    # zero-sum scores (all-zero A, or caller-supplied zeros) fall back
    # to uniform instead of a NaN CDF; `+ stotal * 0` keeps a NaN in
    # the scores propagating rather than silently going uniform
    lam_eff = jnp.where(stotal > 0, jnp.float32(lam), 0.0)
    p = (lam_eff * scores
         / jnp.maximum(stotal, jnp.finfo(jnp.float32).tiny)
         + (1.0 - lam_eff) / m) + stotal * 0
    cdf = weights_to_cdf(p)
    idx, next_state = sample_indices_iid(cdf, s, state)
    p_i = p[idx] / jnp.sum(p)
    scale = 1.0 / jnp.sqrt(s * jnp.maximum(
        p_i, jnp.finfo(jnp.float32).tiny)).astype(a.dtype)
    from .qb import qr_clipped_lstsq
    x = qr_clipped_lstsq(a[idx, :] * scale[:, None],
                         b[idx] * (scale if b.ndim == 1
                                   else scale[:, None]))
    return x, next_state
