"""Spectral density (DOS) estimation: stochastic Lanczos quadrature
and the Kernel Polynomial Method, plus interval eigenvalue counting.

Lin–Saad–Yang 2016 ("Approximating spectral densities of large
matrices"): the eigenvalue distribution phi(t) = sum_i delta(t - l_i)
of a symmetric A, estimated from block matvecs only — the standard
tool for spectrum exploration before committing a rank / shift /
preconditioner budget, and the natural companion of this library's
slq/logdet tier (quadrature.py). Library-tier consumer of the
counter-addressed probe streams (reference ships the sampling
primitives, util.hh:173-334; it has no estimator tier).

Two routes, both one ``lax.scan`` of block matvecs:

- ``spectral_density`` (SLQ): per probe, the Lanczos tridiagonal's
  eigenpairs give Gauss-quadrature nodes/weights for the probe's
  spectral measure; averaging probes and smearing nodes with a
  Gaussian kernel gives the DOS. Nodes adapt to the spectrum (sharp
  where eigenvalues cluster) — the accurate choice at moderate depth.
- ``kpm_density``: Chebyshev-moment expansion with Jackson damping —
  fixed basis, degree-many matvecs per probe, no orthogonalization
  state (cheaper per step than Lanczos at large depth; resolution
  ~ (spectrum width) / degree everywhere).

Accelerator notes: all probes advance together as (n, p) block matvecs
(one (n, p) GEMM per step, never p GEMVs); the Lanczos route
reuses quadrature.py's reorthogonalized block recurrence; the KPM
three-term recurrence needs no reorthogonalization at all (it is a
fixed polynomial, not a basis build) so its scan carries two (n, p)
blocks and nothing else.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..base import require
from ..rng.state import RNGState
from .qb import _apply, _mm_precise
from .quadrature import _block_lanczos_tridiag
from .trace import rademacher_probes

_HI = jax.lax.Precision.HIGHEST


def _matvec_and_n(a, n):
    if callable(a) and not hasattr(a, "shape"):
        require(n is not None, "callable a needs an explicit n")
        return a, n
    require(a.shape[0] == a.shape[1],
            "spectral density needs a square symmetric A")
    return (lambda x: _apply(a, x)), a.shape[0]


def _slq_nodes_weights(a, state: RNGState, probes: int, steps: int,
                       dtype, n: Optional[int]):
    """Gauss-quadrature (nodes, weights) per probe, weights scaled so
    that sum(weights) estimates n (each probe's measure integrates to
    ||v||^2 ~ n for Rademacher probes, exactly n in expectation)."""
    matvec, n = _matvec_and_n(a, n)
    require(probes >= 1, "probes must be >= 1")
    require(1 <= steps <= n, "steps must be in [1, n]")
    v0, nxt = rademacher_probes(n, probes, state, dtype)
    alphas, betas, nrm, _ = _block_lanczos_tridiag(matvec, v0, steps)

    def one(alpha, beta, nv):
        t = jnp.diag(alpha) + jnp.diag(beta, 1) + jnp.diag(beta, -1)
        theta, vecs = jnp.linalg.eigh(t)
        tau2 = vecs[0, :] ** 2
        # Lanczos breakdown parks ghost nodes at ~0 weight; zero them
        # so they cannot smear mass into the density
        live = tau2 > jnp.finfo(tau2.dtype).eps
        return theta, jnp.where(live, tau2, 0.0) * nv ** 2

    nodes, weights = jax.vmap(one)(alphas, betas, nrm.astype(dtype))
    return nodes, weights / probes, nxt, n


def spectral_density(a, state: RNGState, *, probes: int = 16,
                     steps: int = 60, npts: int = 401,
                     grid: Optional[jax.Array] = None,
                     sigma: Optional[float] = None,
                     dtype=jnp.float32, n: Optional[int] = None
                     ) -> Tuple[jax.Array, jax.Array, RNGState]:
    """Smoothed eigenvalue density of symmetric ``a`` by SLQ.

    Returns ``(grid, density, next_state)`` with COUNTING
    normalization: ``trapezoid(density, grid) ~= n`` (the density is
    "eigenvalues per unit of spectrum"). ``a`` is a dense array, sparse
    container, or callable block matvec (pass ``n``).

    ``grid`` defaults to ``npts`` points spanning the Ritz range padded
    by 3 sigma; ``sigma`` (the Gaussian smearing width) defaults to 2%%
    of the Ritz span — resolution and variance trade off through it,
    exactly like a histogram bin width. Depth ``steps`` bounds how many
    distinct spectral clusters the quadrature can resolve (one node per
    cluster); raise it for spiky spectra.
    """
    nodes, weights, nxt, n = _slq_nodes_weights(
        a, state, probes, steps, dtype, n)
    lo = jnp.min(nodes)
    hi = jnp.max(nodes)
    span = jnp.maximum(hi - lo, jnp.finfo(dtype).tiny)
    sig = span * 0.02 if sigma is None else jnp.asarray(sigma, dtype)
    if grid is None:
        require(npts >= 2, "npts must be >= 2")
        grid = jnp.linspace(lo - 3 * sig, hi + 3 * sig, npts,
                            dtype=dtype)
    # density(t) = sum_nodes w * N(t; node, sigma)
    z = (grid[:, None] - nodes.reshape(-1)[None, :]) / sig
    kern = jnp.exp(-0.5 * z * z) / (sig * jnp.sqrt(2 * jnp.pi))
    dens = jnp.matmul(kern, weights.reshape(-1), precision=_HI)
    return grid, dens, nxt


def eig_count(a, lo: float, hi: float, state: RNGState, *,
              probes: int = 16, steps: int = 60, dtype=jnp.float32,
              n: Optional[int] = None) -> Tuple[jax.Array, RNGState]:
    """Estimate the number of eigenvalues of symmetric ``a`` in
    ``[lo, hi]`` — tr(indicator_{[lo,hi]}(A)) — by summing the SLQ
    quadrature mass whose nodes land inside the interval.

    The hard-indicator quadrature converges slower than smooth-f SLQ
    (the integrand is discontinuous), but node-mass summation is
    accurate whenever the interval endpoints fall in spectral GAPS —
    the situation where eigenvalue counts are well-posed. Near-endpoint
    eigenvalues split their Gaussian-smeared mass across the boundary;
    raise ``steps`` to sharpen nodes. Returns ``(count, next_state)``.
    """
    require(hi > lo, "need hi > lo")
    nodes, weights, nxt, _ = _slq_nodes_weights(
        a, state, probes, steps, dtype, n)
    inside = (nodes >= lo) & (nodes <= hi)
    return jnp.sum(jnp.where(inside, weights, 0.0)), nxt


def kpm_density(a, state: RNGState, *, degree: int = 128,
                probes: int = 16, npts: int = 401,
                bounds: Optional[Tuple[float, float]] = None,
                grid: Optional[jax.Array] = None, dtype=jnp.float32,
                n: Optional[int] = None
                ) -> Tuple[jax.Array, jax.Array, RNGState]:
    """Eigenvalue density of symmetric ``a`` by the Kernel Polynomial
    Method: Jackson-damped Chebyshev expansion of the DOS (Weisse et
    al. 2006; Lin–Saad–Yang 2016 sec. 3.2).

    ``bounds = (lmin, lmax)`` must enclose the spectrum — REQUIRED
    unless ``a`` is a dense array (then a Gershgorin enclosure is
    computed, always safe). Chebyshev iterates of an un-enclosed
    operator blow up exponentially; that is a property of the method,
    so the enclosure is the caller's contract, not a tolerance knob.
    The moment recurrence doubles up: 2*degree moments from degree
    matvecs via T_{2k} = 2 T_k^2 - T_0 identities' stochastic analog
    being unstable, KPM uses the plain recurrence — ``degree`` matvecs
    per probe, 2 live (n, p) blocks of state.

    Returns ``(grid, density, next_state)`` with counting
    normalization (integrates to ~n). Resolution is uniform,
    ~ span / degree; prefer :func:`spectral_density` when eigenvalue
    clusters need adaptive sharpness.
    """
    matvec, n = _matvec_and_n(a, n)
    require(probes >= 1, "probes must be >= 1")
    require(degree >= 2, "degree must be >= 2")
    if bounds is None:
        require(hasattr(a, "shape") and not callable(a),
                "kpm_density needs explicit spectrum bounds for "
                "callable operators (Chebyshev iterates of an "
                "un-enclosed operator diverge)")
        # Gershgorin: every eigenvalue lies in union of
        # [a_ii - r_i, a_ii + r_i], r_i the off-diagonal abs row sum
        from .qb import _is_sparse
        if _is_sparse(a):
            # sparse-aware enclosure (ADVICE r4: COO/CSR/CSC expose
            # .shape, so they reached the dense branch and crashed in
            # jnp.diagonal). Duplicate triplets are legal in COO, so
            # diag/row sums are scatter-adds over all entries.
            from ..sparse_data.conversions import to_coo
            c = to_coo(a)
            absv = jnp.abs(c.vals)
            ondiag = c.rows == c.cols
            ri_all = jnp.zeros((n,), absv.dtype).at[c.rows].add(absv)
            di = jnp.zeros((n,), c.vals.dtype).at[c.rows].add(
                jnp.where(ondiag, c.vals, 0))
            ri = ri_all - jnp.zeros((n,), absv.dtype).at[c.rows].add(
                jnp.where(ondiag, absv, 0))
        else:
            di = jnp.diagonal(a)
            ri = jnp.sum(jnp.abs(a), axis=1) - jnp.abs(di)
        lmin, lmax = jnp.min(di - ri), jnp.max(di + ri)
    else:
        lmin = jnp.asarray(bounds[0], dtype)
        lmax = jnp.asarray(bounds[1], dtype)
    # affine map to [-1+eps_pad, 1-eps_pad]: t = (l - c) / h
    pad = 0.01
    c = (lmax + lmin) / 2
    h = jnp.maximum((lmax - lmin) / 2, jnp.finfo(dtype).tiny) \
        / (1 - pad)

    v0, nxt = rademacher_probes(n, probes, state, dtype)
    amap = lambda x: (matvec(x).astype(dtype) - c * x) / h

    def step(carry, _):
        t_prev, t_cur = carry
        t_next = 2 * amap(t_cur) - t_prev
        mu = jnp.sum(v0 * t_next, dtype=dtype) / (n * probes)
        return (t_cur, t_next), mu

    t1 = amap(v0)
    mu0 = jnp.asarray(1.0, dtype)                      # tr(T_0)/n
    mu1 = jnp.sum(v0 * t1, dtype=dtype) / (n * probes)
    _, mus = jax.lax.scan(step, (v0, t1), None, length=degree - 2)
    mu = jnp.concatenate([jnp.stack([mu0, mu1]), mus])  # (degree,)

    # Jackson damping: kills Gibbs oscillation of the truncated series
    k = jnp.arange(degree, dtype=dtype)
    dd = jnp.asarray(degree, dtype)
    g = ((dd - k + 1) * jnp.cos(jnp.pi * k / (dd + 1))
         + jnp.sin(jnp.pi * k / (dd + 1))
         / jnp.tan(jnp.pi / (dd + 1))) / (dd + 1)

    if grid is None:
        require(npts >= 2, "npts must be >= 2")
        grid = jnp.linspace(lmin, lmax, npts, dtype=dtype)
    t = jnp.clip((grid - c) / h, -1 + 1e-6, 1 - 1e-6)
    # phi(t) = (1/(pi sqrt(1-t^2))) * (g0 mu0 + 2 sum_k g_k mu_k T_k(t))
    theta = jnp.arccos(t)                              # T_k(t)=cos(k θ)
    tk = jnp.cos(theta[:, None] * k[None, :])          # (npts, degree)
    coef = g * mu * jnp.where(k == 0, 1.0, 2.0)
    phi_t = jnp.matmul(tk, coef, precision=_HI) \
        / (jnp.pi * jnp.sqrt(1 - t * t))
    # back to lambda domain with counting normalization:
    # density(l) dl = n * phi(t) dt, dt/dl = 1/h
    dens = jnp.maximum(n * phi_t / h, 0.0)
    return grid, dens, nxt
