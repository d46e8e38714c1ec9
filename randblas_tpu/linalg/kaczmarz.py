"""Row- and column-action iterative solvers: block randomized Kaczmarz
and randomized block Gauss–Seidel (coordinate descent).

Library-tier consumers of the counter-based sampling streams
(util.weights_to_cdf + util.sample_indices_iid — the machinery the
reference ships in util.hh:173-334; the reference has the sampler, not
these consumers). The design choice is BLOCKS: single-row
Kaczmarz (Strohmer–Vershynin 2009) is a latency-bound scalar update, a
shape no matrix unit can love — sampling a block of rows per step turns each
update into a gather + two thin GEMMs + one small Cholesky-style solve,
and the expected per-sweep contraction rate improves with block size
(Needell–Tropp 2014). All sampling happens UPFRONT from the chained
Uniform stream, so a solve is a pure function of (A, b, state) and the
whole iteration is a ``lax.scan``.

Which one to use:
- ``block_kaczmarz`` — row action. Projects onto sampled row blocks'
  solution spaces; converges geometrically to the solution of a
  CONSISTENT system (and to a residual-sized horizon around the LS
  solution otherwise). Use when rows arrive/are affordable one block
  at a time (out-of-core, streaming).
- ``block_gauss_seidel`` — column action on the normal equations
  (Leventhal–Lewis 2010). Converges geometrically to the LEAST-SQUARES
  solution of tall full-rank systems, consistent or not; maintains the
  residual incrementally so each step touches only the sampled columns.
For in-core problems where a full sketching pass over A is affordable,
``sketch_and_precondition`` (lstsq.py) remains the faster route — these
solvers' edge is the restricted-access model.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..base import require
from ..rng.state import RNGState
from ..util import sample_indices_iid, sample_indices_iid_uniform, \
    weights_to_cdf

_HI = jax.lax.Precision.HIGHEST


def _sample_blocks(w: Optional[jax.Array], n: int, steps: int,
                   block: int, state: RNGState
                   ) -> Tuple[jax.Array, RNGState]:
    """(steps, block) int32 indices from the chained Uniform stream —
    importance-sampled from weights `w` (importance ∝ w) or uniform
    when w is None. One stream read for the whole solve."""
    if w is None:
        idx, nxt = sample_indices_iid_uniform(n, steps * block, state)
    else:
        cdf = weights_to_cdf(w)
        idx, nxt = sample_indices_iid(cdf, steps * block, state)
    return idx.reshape(steps, block), nxt


def _damped_spd_solve(g: jax.Array, rhs: jax.Array) -> jax.Array:
    """Solve (G + lam I) y = rhs for a small PSD Gram block. iid
    sampling DUPLICATES rows/columns inside a block with probability
    ~ block^2 / (2n), which makes G exactly singular — the eps-scale
    Tikhonov floor keeps the Cholesky solve finite and perturbs
    well-separated directions by O(eps). The floor rides trace(G) so
    it scales with the data; the tiny() floor keeps an all-zero block
    (possible with zero rows of A) solving to y == 0."""
    s = g.shape[0]
    lam = jnp.maximum(jnp.finfo(g.dtype).eps * jnp.trace(g) / s * 8.0,
                      jnp.finfo(g.dtype).tiny)
    gd = g + lam * jnp.eye(s, dtype=g.dtype)
    cf = jax.scipy.linalg.cho_factor(gd, lower=True)
    return jax.scipy.linalg.cho_solve(cf, rhs)


def block_kaczmarz(a: jax.Array, b: jax.Array, state: RNGState, *,
                   block: int = 256, steps: int = 64,
                   x0: Optional[jax.Array] = None,
                   sampling: str = "rownorm"
                   ) -> Tuple[jax.Array, RNGState]:
    """Block randomized Kaczmarz for ``A x = b`` (consistent systems).

    Each step samples ``block`` rows tau (probabilities ∝ ||a_i||^2
    for ``sampling='rownorm'`` — the Strohmer–Vershynin weighting —
    or ``'uniform'``) and projects x onto the block's solution space:

        x <- x + A_tau^+ (b_tau - A_tau x),
        A_tau^+ applied via the damped (block, block) Gram solve.

    Converges geometrically in expectation for consistent systems at a
    rate governed by the block-conditioned scaled condition number;
    for inconsistent b it stalls at a ||r*||-sized horizon — use
    :func:`block_gauss_seidel` (or sketch_and_precondition) for true
    least squares. Returns ``(x, next_state)``; the whole solve is one
    ``lax.scan`` over pre-sampled indices, jittable end to end.
    """
    require(a.ndim == 2, "block_kaczmarz takes a matrix A")
    m, n = a.shape
    require(b.shape[0] == m, "b must have A's row count")
    require(1 <= block <= m, "block must be in [1, m]")
    require(steps >= 1, "need at least one step")
    require(sampling in ("rownorm", "uniform"),
            "sampling must be 'rownorm' or 'uniform'")

    w = None
    if sampling == "rownorm":
        w = jnp.einsum("ij,ij->i", a, a, precision=_HI)
        # all-zero A: fall back to uniform rather than a NaN CDF, but
        # keep a NaN in the weights propagating
        w = jnp.where(jnp.sum(w) > 0, w, jnp.ones_like(w)) \
            + jnp.sum(w) * 0
    idx, nxt = _sample_blocks(w, m, steps, block, state)

    x_init = jnp.zeros((n,) + b.shape[1:], a.dtype) if x0 is None else \
        x0.astype(a.dtype)

    def step(x, ix):
        rows = a[ix]                                      # (s, n)
        r = b[ix] - jnp.matmul(rows, x, precision=_HI)
        g = jnp.matmul(rows, rows.T, precision=_HI)
        y = _damped_spd_solve(g, r)
        return x + jnp.matmul(rows.T, y, precision=_HI), None

    x, _ = jax.lax.scan(step, x_init, idx)
    return x, nxt


def block_gauss_seidel(a: jax.Array, b: jax.Array, state: RNGState, *,
                       block: int = 256, steps: int = 64,
                       x0: Optional[jax.Array] = None,
                       sampling: str = "shuffle"
                       ) -> Tuple[jax.Array, RNGState]:
    """Randomized block Gauss–Seidel / coordinate descent for tall
    least squares ``min ||A x - b||`` (Leventhal–Lewis 2010, block
    form).

    Each step takes a block of columns J and minimizes the residual
    exactly over those coordinates:

        dx = (A_J)^+ r,   x_J <- x_J + dx,   r <- r - A_J dx

    The residual is carried incrementally, so a step reads only the
    sampled (m, block) column panel — the restricted-access sibling of
    CGLS. Converges geometrically in expectation to the LS solution
    for full-column-rank A, consistent or not. Returns
    ``(x, next_state)``.

    ``sampling`` picks how blocks are chosen — the default is
    ``'shuffle'``: ONE counter-addressed random permutation of the
    columns per solve, then cyclic sweeps over the fixed partition of
    the permuted A^T. The fixed partition lets each block's damped
    Gram inverse be computed once and reused every sweep, so a step is
    just three GEMVs instead of a Gram + Cholesky per step — and iid
    index gathers (``'colnorm'`` — LL10's importance weighting — or
    ``'uniform'``) mean fresh indices, hence a fresh Gram, every
    step. Solution quality is
    the same — shuffled sweeps also visit every column per sweep (no
    duplicates), which in practice contracts at least as fast as iid
    draws. Use the iid modes when LL10's importance-sampling theory is
    the point.
    """
    require(a.ndim == 2, "block_gauss_seidel takes a matrix A")
    m, n = a.shape
    require(b.shape[0] == m, "b must have A's row count")
    require(b.ndim == 1, "block_gauss_seidel takes a single RHS vector")
    require(1 <= block <= n, "block must be in [1, n]")
    require(steps >= 1, "need at least one step")
    require(sampling in ("shuffle", "colnorm", "uniform"),
            "sampling must be 'shuffle', 'colnorm' or 'uniform'")

    x_init = jnp.zeros((n,), a.dtype) if x0 is None else \
        x0.astype(a.dtype)
    r_init = b.astype(a.dtype) - jnp.matmul(a, x_init, precision=_HI)

    if sampling == "shuffle":
        return _gauss_seidel_shuffle(a, x_init, r_init, state,
                                     block, steps)

    w = None
    if sampling == "colnorm":
        w = jnp.einsum("ij,ij->j", a, a, precision=_HI)
        w = jnp.where(jnp.sum(w) > 0, w, jnp.ones_like(w)) \
            + jnp.sum(w) * 0
    idx, nxt = _sample_blocks(w, n, steps, block, state)
    at = a.T

    def step(carry, jx):
        x, r = carry
        panel = at[jx]                                    # (s, m) rows
        g = jnp.matmul(panel, panel.T,               # default: see the
                       preferred_element_type=panel.dtype)  # shuffle path

        rhs = jnp.matmul(panel, r, precision=_HI)
        dx = _damped_spd_solve(g, rhs)
        # duplicate column indices inside a block would make .at[].add
        # apply BOTH copies' updates to one coordinate; the damped Gram
        # solve already splits the update evenly across duplicates, so
        # the sum is exactly the intended total step
        x = x.at[jx].add(dx)
        r = r - jnp.matmul(panel.T, dx, precision=_HI)
        return (x, r), None

    (x, _), _ = jax.lax.scan(step, (x_init, r_init), idx)
    return x, nxt


def _gauss_seidel_shuffle(a, x_init, r_init, state: RNGState,
                          block: int, steps: int
                          ) -> Tuple[jax.Array, RNGState]:
    """Shuffled-partition block Gauss–Seidel: permute the columns once
    (argsort of one counter-addressed Uniform row — reproducible and
    seed-chained like every operator), pad A^T's permuted rows up to a
    whole number of blocks with zero rows (phantom coordinates: zero
    panel row makes their rhs — and so their update — exactly 0), then
    sweep the fixed partition cyclically. All data movement is
    contiguous; no iid gather anywhere.

    The fixed partition means each block's damped Gram inverse is
    computed ONCE and reused every sweep — the sweeps' per-step work
    collapses to two (block, m) GEMVs + one (block, block) GEMV. The
    Gram GEMM is the FLOP bulk, so it runs at DEFAULT precision (preconditioner role: the fixed
    point is pinned by rhs and the residual update, which stay at
    HIGHEST; the on-chip test asserts final accuracy). Explicit
    inverses (not stored factors) are fine for the same reason, and
    make the sweep step a GEMV instead of two triangular solves."""
    from ..dense import DenseDist, DenseDistName, DenseSkOp
    m, n = a.shape
    u_op = DenseSkOp(DenseDist(1, n, family=DenseDistName.Uniform),
                     state, dtype=jnp.float32)
    perm = jnp.argsort(u_op.materialize()[0])
    nxt = u_op.next_state

    nblocks = -(-n // block)
    n_pad = nblocks * block
    at_p = a.T[perm]
    if n_pad > n:
        at_p = jnp.concatenate(
            [at_p, jnp.zeros((n_pad - n, m), a.dtype)])
    panels = at_p.reshape(nblocks, block, m)
    grams = jnp.einsum("bij,bkj->bik", panels, panels,
                       preferred_element_type=a.dtype)
    s = block
    lam = jnp.maximum(
        jnp.finfo(a.dtype).eps * jnp.einsum("bii->b", grams) / s * 8.0,
        jnp.finfo(a.dtype).tiny)
    grams = grams + lam[:, None, None] * jnp.eye(s, dtype=a.dtype)
    eye = jnp.eye(s, dtype=a.dtype)
    invs = jax.vmap(lambda g: jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(g, lower=True), eye))(grams)

    xp_init = jnp.zeros((n_pad,), a.dtype).at[:n].set(x_init[perm])
    order = jnp.arange(steps, dtype=jnp.int32) % nblocks

    def step(carry, bi):
        xp, r = carry
        panel = panels[bi]
        rhs = jnp.matmul(panel, r, precision=_HI)
        dx = jnp.matmul(invs[bi], rhs, precision=_HI)
        st = bi * block
        xs = jax.lax.dynamic_slice(xp, (st,), (block,))
        xp = jax.lax.dynamic_update_slice(xp, xs + dx, (st,))
        r = r - jnp.matmul(panel.T, dx, precision=_HI)
        return (xp, r), None

    (xp, _), _ = jax.lax.scan(step, (xp_init, r_init), order)
    x = jnp.zeros((n,), a.dtype).at[perm].set(xp[:n])
    return x, nxt
