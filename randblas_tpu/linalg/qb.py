"""QB decomposition / randomized rangefinder with power iteration.

Counterpart of the reference's sparse-low-rank-approx examples
(svd_rank1_plus_noise.cc:217-300, qrcp_matrixmarket.cc:220-283): sketch the
range of A with an implicit Gaussian operator, stabilize with QR between
power-iteration passes, then compress. Works for dense (jnp array) and
sparse (COO/CSR/CSC) data.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..base import require
from ..dense import DenseDist, DenseSkOp
from ..rng.state import RNGState
from ..skge import sketch_general
from ..sparse_data.spmm import left_spmm


def _is_sparse(a) -> bool:
    from ..sparse_data.coo import COOMatrix
    from ..sparse_data.csc import CSCMatrix
    from ..sparse_data.csr import CSRMatrix
    return isinstance(a, (COOMatrix, CSRMatrix, CSCMatrix))


def _apply(a, x):
    """a @ x for dense or sparse a. Dense products go through
    skge._matmul, so f64 follows the library's use_hiprec_f64 policy
    (native f64 unless the int8-sliced GEMM is forced)."""
    if _is_sparse(a):
        return left_spmm(a, x)
    from ..skge import _matmul
    return _matmul(a, x, x.dtype)


def _apply_t(a, x):
    """a.T @ x for dense or sparse a (same f64 routing as _apply)."""
    if _is_sparse(a):
        return left_spmm(a, x, op_a="T")
    from ..skge import _matmul
    return _matmul(a.T, x, x.dtype)


def _mm_precise(x, y):
    """Full-precision matmul for the certificate/adaptive paths. A
    default-precision f32 product runs with reduced-precision operands
    on an accelerator (TF32 on the GPU, ~5e-4 relative rounding), which
    floors residuals of captured ranges well above a tight tol — the
    adaptive loop then can never certify it and absorbs junk blocks to
    its cap. Precision.HIGHEST forces full f32; these are thin
    (m, k) x (k, b) products, so the extra cost is negligible."""
    return jnp.matmul(x, y, precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=y.dtype)


def _apply_precise(a, x):
    """a @ x at certificate precision: dense f32/bf16 products run at
    Precision.HIGHEST (see _mm_precise); f64 keeps the hiprec routing
    (already ~f64-accurate); sparse applies are exact gathers/sums."""
    if _is_sparse(a) or x.dtype == jnp.float64:
        return _apply(a, x)
    return _mm_precise(a, x)


def make_matvec(a):
    """``v -> A @ v`` on (n,) vectors for dense / sparse / callable A,
    with the round-4 precision policy shared by the Krylov consumers
    (sgmres, sketched_eigs): dense sub-f64 products run at
    Precision.HIGHEST — a matvec is memory-bandwidth-bound, so the
    full-f32 product is free, while a reduced-precision default product
    visibly corrupts Krylov bases (caught on chip by the sgmres
    hardware test) — and dense f64 goes through _apply. Callers cast the output to their basis
    dtype (the Arnoldi loop body does; ADVICE r3)."""
    if callable(a):
        return a
    if _is_sparse(a) or a.dtype == jnp.float64:
        return lambda v: _apply(a, v[:, None])[:, 0]
    return lambda v: jnp.matmul(a, v,
                                precision=jax.lax.Precision.HIGHEST)


def safe_svd(x: jax.Array, full_matrices: bool = False):
    """``jnp.linalg.svd`` with the x64 trace context scoped OFF for
    sub-f64 inputs.

    x64 mode changes only index types for f32 DATA, so scoping it off
    around the trace is value-identical; it keeps the SVD graph of
    every SVD consumer (rsvd, nystrom, sketched_eigs, streaming, ...)
    the same in x64-enabled sessions as elsewhere. f64 inputs keep the
    x64 context (disabling would downcast)."""
    if x.dtype == jnp.float64:
        return jnp.linalg.svd(x, full_matrices=full_matrices)
    with jax.enable_x64(False):
        return jnp.linalg.svd(x, full_matrices=full_matrices)


def qr_clipped_lstsq(a: jax.Array, b: jax.Array) -> jax.Array:
    """Least-squares solve of a tall ``a @ y = b`` via Tikhonov-damped
    Householder QR: solve ``min || [a; lam*I] y - [b; 0] ||`` with
    ``lam = eps * m * ||a||_F`` — directions with singular value
    sigma >> lam get the exact LS coefficient (relative perturbation
    (lam/sigma)^2), directions with sigma << lam (exact-zero breakdown
    columns, numerically dependent basis vectors) are smoothly clipped
    toward 0, exactly the role lstsq's rcond cutoff plays. The damped
    system is full-rank by construction, so the triangular solve never
    divides by ~0. (Plain unpivoted-QR column dropping is NOT valid
    here: row i of R still constrains the later variables.)

    This replaces ``jnp.linalg.lstsq`` on the sketched-solve paths: the
    damping gives the rank-deficient (breakdown) bases a smooth cutoff
    with one Householder QR and no SVD.
    ``b`` may be a vector or a matrix of stacked right-hand sides."""
    m = a.shape[1]
    # tiny floor ON THE PRODUCT: an all-zero `a` would give lam == 0, a
    # rank-0 damped system, and 0/0 in the triangular solve (review
    # find). The floor must be the smallest NORMAL float — flooring the
    # norm instead leaves eps*m*tiny subnormal, which an accelerator may
    # flush to zero, resurrecting the NaN. With the floor the
    # zero system solves to y == 0 exactly, matching lstsq.
    lam = jnp.maximum(jnp.finfo(a.dtype).eps * m * jnp.linalg.norm(a),
                      jnp.finfo(a.dtype).tiny)
    aug = jnp.concatenate([a, lam * jnp.eye(m, dtype=a.dtype)])
    zeros = jnp.zeros((m,) + b.shape[1:], b.dtype)
    rhs = jnp.concatenate([b, zeros])
    q, r = jnp.linalg.qr(aug)
    # HIGHEST: the projection is a thin product, and reduced-precision
    # default rounding would dominate the solve's accuracy
    qtb = jnp.matmul(q.T, rhs, precision=jax.lax.Precision.HIGHEST)
    return jax.scipy.linalg.solve_triangular(r, qtb, lower=False)


def _orth(y: jax.Array, how: str) -> jax.Array:
    """Tall-skinny orthonormalization for the rangefinder family.
    'cholqr' (default) = rescued CholQR2 — all-GEMM, no sequential
    Householder panel; 'qr' = Householder, unconditionally stable, for
    extreme-conditioning edge cases."""
    if how == "cholqr":
        from .distributed import cholqr
        q, _ = cholqr(y)
        return q
    require(how == "qr", "orth must be 'cholqr' or 'qr'")
    q, _ = jnp.linalg.qr(y)
    return q


def _stabilize(y: jax.Array, how: str) -> jax.Array:
    """Between-pass stabilization for the power iteration — the three
    schemes the reference's QRCP example walks through
    (qrcp_matrixmarket.cc:220-283): full orthonormalization ('qr' /
    'cholqr', strongest), pivoted-LU span extraction ('lu' — P @ unit-L
    spans the same space with bounded conditioning at roughly half the
    cost of QR), or nothing ('none' — one pass of drift is fine when
    every other pass orthonormalizes; the spectrum-squaring makes
    un-stabilized columns collapse onto the leading subspace only after
    ~2 ungated passes at f32). The FINAL basis is always produced by
    _orth, so the rangefinder's output is orthonormal regardless."""
    if how == "none":
        return y
    if how == "lu":
        m, k = y.shape
        lu, _, perm = jax.lax.linalg.lu(y)       # y[perm] == L @ U
        l = jnp.tril(lu, -1)[:, :k] + jnp.eye(m, k, dtype=y.dtype)
        # U is k x k nonsingular (generic y), so span(y) == span(P^T L):
        # y[perm[i]] = (L U)[i]  =>  y = (L U)[inv] with inv o perm = id
        inv = jnp.zeros_like(perm).at[perm].set(
            jnp.arange(perm.shape[0], dtype=perm.dtype))
        return l[inv]
    return _orth(y, how)


def rangefinder(a, k: int, state: RNGState, power_iters: int = 2,
                dtype=jnp.float32, operator: str = "gaussian",
                orth: str = "cholqr", stabilizer: str = None) -> jax.Array:
    """Orthonormal Q (m x k) approximating range(A) via sketch + power
    iteration with re-stabilization each pass.

    ``operator`` picks the rangefinder's embedding family ('gaussian' |
    'saso' | 'srht', dense data only for the latter two): the initial
    sketch becomes A @ S^T with S a (k, n) operator, so 'srht' costs
    O(mn log n) instead of the dense 2mnk — cheaper whenever
    k > log2(n)/2, i.e. essentially always. ``orth`` picks the FINAL
    orthonormalizer (see _orth; 'cholqr' is all-GEMM).
    ``stabilizer`` picks the BETWEEN-pass scheme ('cholqr' | 'qr' |
    'lu' | 'none', default = same as orth) — the stabilization-variant
    menu of the reference's QRCP example (qrcp_matrixmarket.cc:220-283);
    see _stabilize and examples/qrcp_low_rank.py's variant study."""
    n_rows, n_cols = a.shape
    require(k <= min(n_rows, n_cols), "rank must be <= min dim")
    stabilizer = orth if stabilizer is None else stabilizer
    if operator == "gaussian" or _is_sparse(a):
        require(operator == "gaussian",
                "sparse data supports only the 'gaussian' rangefinder "
                "(materialized thin operator through the SpMM dispatcher)")
        S = DenseSkOp(DenseDist(n_cols, k), state, dtype=dtype)
        y = _apply(a, S.materialize())          # (m, k)
    else:
        from .embed import make_embedding
        S = make_embedding(operator, k, n_cols, state, dtype=dtype)
        y = sketch_general(S, a.astype(dtype), side="right", op_s="T")
    for i in range(power_iters):
        q = _stabilize(y, stabilizer)
        z = _apply_t(a, q)
        w = _stabilize(z, stabilizer)
        y = _apply(a, w)
    return _orth(y, orth)


def qb_decompose(a, k: int, state: RNGState, power_iters: int = 2,
                 dtype=jnp.float32, operator: str = "gaussian",
                 orth: str = "cholqr") -> Tuple[jax.Array, jax.Array]:
    """A ~= Q @ B with Q (m x k) orthonormal, B = Q^T A (k x n)."""
    q = rangefinder(a, k, state, power_iters, dtype, operator, orth=orth)
    b = _apply_t(a, q).T if _is_sparse(a) else jnp.matmul(
        q.T, a, preferred_element_type=dtype)
    return q, b


def qb_to_svd(q: jax.Array, b: jax.Array):
    """SVD of A from its QB factorization (svd_rank1_plus_noise.cc:264-300):
    svd(B) on the small k x n factor, then U = Q Ub."""
    ub, s, vt = safe_svd(b, full_matrices=False)
    u = jnp.matmul(q, ub)
    return u, s, vt


def adaptive_rangefinder(a, tol: float, state: RNGState, *,
                         block: int = 16, max_rank: int = None,
                         alpha: float = 10.0, dtype=jnp.float32
                         ) -> Tuple[jax.Array, jax.Array, RNGState]:
    """Grow an orthonormal basis Q until ``||(I - Q Q^T) A||_2 <= tol``
    is CERTIFIED (probability >= 1 - alpha**(-block) per check) — the
    rank-adaptive rangefinder of Halko-Martinsson-Tropp 2011 alg. 4.2,
    blocked: each round draws ``block`` fresh Gaussian probe columns,
    uses their residuals against the current basis both as the error
    certificate (range_error_estimate's bound) and, if the bound is
    still above ``tol``, as the next basis block (the probes are never
    wasted). Returns ``(q, bound, next_state)`` with ``bound`` the
    certified estimate at exit.

    The loop is host-driven (the basis width is data-dependent, which
    cannot live under one jit); each round's work is three GEMM-shaped
    products and a thin QR, and the number of distinct compiled shapes
    is rank/block. ``max_rank`` caps the basis (default min(A.shape)
    rounded down to a block multiple; the cap returning with
    bound > tol means A's tail is heavier than tol).

    The fixed-rank ``rangefinder``/``krylov_rangefinder`` remain the
    right call when k is known — they add power/Krylov iterations this
    adaptive form does not.

    Choosing ``tol``: the certificate overestimates the spectral norm by
    up to ~||E||_F / ||E||_2 (probe residual norms concentrate at the
    FROBENIUS scale), so for heavy/noisy tails set ``tol`` at the
    Frobenius level of the residual you will tolerate, not its spectral
    norm — a tol below the certificate's noise floor makes the loop
    absorb the noise space block by block until max_rank.
    """
    m, n = a.shape
    require(tol > 0, "tol must be > 0")
    require(block >= 1, "block must be >= 1")
    limit = min(m, n) if max_rank is None else min(max_rank, min(m, n))
    scale = alpha * float(jnp.sqrt(2.0 / jnp.pi))
    q = jnp.zeros((m, 0), dtype)
    st = state
    a_scale = None
    while True:
        S = DenseSkOp(DenseDist(n, block), st, dtype=dtype)
        y = _apply_precise(a, S.materialize())      # (m, block)
        st = S.next_state
        r = y - _mm_precise(q, _mm_precise(q.T, y))
        mx = float(jnp.max(jnp.linalg.norm(r, axis=0)))
        bound = scale * mx
        if a_scale is None:
            a_scale = mx                            # first round: r == y
        if bound <= tol or q.shape[1] >= limit:
            return q, jnp.asarray(bound, dtype), st
        r = r - _mm_precise(q, _mm_precise(q.T, r))  # second GS pass
        # SVD-based orthonormalization with a rank cutoff: residual
        # blocks go rank-deficient once most of the range is captured,
        # and plain QR turns their numerically-zero columns into
        # only-approximately-orthogonal junk that DESTROYS the basis
        # (observed: orthogonality error 0.77, "bound" exploding to
        # ~700 on an exactly low-rank A with an unreachable tol). Keep
        # only directions with real content; zero survivors means the
        # range is captured to working precision — stop.
        ur, sr, _ = safe_svd(r, full_matrices=False)
        cut = 20.0 * float(jnp.finfo(dtype).eps) * float(m) ** 0.5 \
            * a_scale
        keep = int((np.asarray(sr) > cut).sum())
        keep = min(keep, limit - q.shape[1])
        if keep == 0:
            return q, jnp.asarray(bound, dtype), st
        q = jnp.concatenate([q, ur[:, :keep]], axis=1)


def range_error_estimate(a, q: jax.Array, state: RNGState, *,
                         probes: int = 10, alpha: float = 10.0,
                         dtype=None) -> Tuple[jax.Array, RNGState]:
    """A-posteriori certificate for a rangefinder basis: a bound on
    ``||(I - Q Q^T) A||_2`` that holds with probability at least
    ``1 - alpha**(-probes)`` (Halko-Martinsson-Tropp 2011, alg. 4.3 /
    eq. 4.3):

        bound = alpha * sqrt(2/pi) * max_j ||(I - Q Q^T) A w_j||

    over ``probes`` iid Gaussian probe vectors ``w_j`` (counter-addressed
    and seed-chained like every estimator in this tier). Defaults give a
    1 - 1e-10 certificate from 10 extra matvecs. The reference's QB
    example iterates blindly to a fixed depth; this is the cheap check
    that lets adaptive pipelines stop when the range is captured.
    Returns ``(bound, next_state)``.
    """
    m, n = a.shape
    require(q.shape[0] == m, "q must have A's row count")
    require(probes >= 1, "probes must be >= 1")
    dtype = dtype or q.dtype
    W = DenseSkOp(DenseDist(n, probes), state, dtype=dtype)
    y = _apply_precise(a, W.materialize())          # (m, probes)
    r = y - _mm_precise(q, _mm_precise(q.T, y))
    norms = jnp.linalg.norm(r, axis=0)
    bound = alpha * jnp.sqrt(2.0 / jnp.pi) * jnp.max(norms)
    return bound.astype(dtype), W.next_state
