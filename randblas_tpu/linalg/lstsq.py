"""Sketched overdetermined least squares: sketch-and-solve and
sketch-and-precondition (Blendenpik / LSRN family).

The two classic RandNLA regression workloads next to the reference's TLS
examples (/root/reference/examples/total-least-squares/
tls_dense_skop.cc:101-203):

  * sketch-and-solve: solve min ||S A x - S b|| on a d ~ 2n row sketch —
    one small QR, delta-accurate (residual within (1+delta) of optimal).
  * sketch-and-precondition: use R from qr(S A) as a RIGHT preconditioner
    for CGLS on the FULL problem — cond(A R^-1) = O(1) with high
    probability, so the iteration converges in a few dozen steps
    independent of cond(A), to full solver accuracy.

Accelerator notes: the sketch rides sketch_general / sketch_sparse
dispatch; CGLS is a lax.while_loop of two GEMV-shaped products; block
right-hand sides get per-column step sizes so the whole block converges
in one loop. f64 products follow the library's f64 routing (native f64
by default).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from ..base import require
from ..rng.state import RNGState
from ..skge import sketch_general
from ..sksp import sketch_sparse
from ..sparse import SparseSkOp
from .embed import make_embedding
from .qb import _apply, _apply_t, _is_sparse


def cgls(matvec: Callable, rmatvec: Callable, b: jax.Array, n: int, *,
         x0: Optional[jax.Array] = None, tol: Optional[float] = None,
         maxiter: int = 100) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Conjugate gradient on the normal equations (CGLS), in-graph.

    Solves min ||M x - b|| for the operator given by ``matvec`` (n -> m)
    and ``rmatvec`` (m -> n). ``b`` may be (m,) or (m, k); block right-hand
    sides use independent per-column step sizes. Stops when every
    column's normal-equation residual ||M^T r|| has dropped below
    ``tol * ||M^T b||`` (relative to the ZERO-start residual even when
    ``x0`` is given — a threshold relative to a good warm start is
    unreachable, and CG iterated past machine precision amplifies
    rounding noise instead of staying converged), or after ``maxiter``
    iterations. ``tol`` defaults to 100x the dtype epsilon.

    Divergence guard: CG iterated past the working precision does not
    stagnate, it AMPLIFIES rounding noise (observed: gamma 4.5e-15 ->
    4.7 within 100 extra iterations). The loop therefore tracks the
    best iterate per column and returns THAT, and it exits early once
    every unconverged column's residual sits far (1e4x) above its own
    best — an unreachably tight ``tol`` now costs at most wasted
    iterations, never a diverged answer.

    Returns ``(x, iterations, gamma)`` with ``gamma`` the best squared
    normal-residual norm per column.
    """
    vec = b.ndim == 1
    bb = b[:, None] if vec else b
    if tol is None:
        tol = 100.0 * float(jnp.finfo(bb.dtype).eps)
    x0b = (jnp.zeros((n, bb.shape[1]), bb.dtype) if x0 is None
           else (x0[:, None] if vec else x0))
    r0 = bb - matvec(x0b)
    s0 = rmatvec(r0)
    gamma0 = jnp.sum(s0 * s0, axis=0)                       # (k,)
    if x0 is None:
        gamma_ref = gamma0
    else:
        sb = rmatvec(bb)
        gamma_ref = jnp.sum(sb * sb, axis=0)
    eps_floor = jnp.asarray(jnp.finfo(bb.dtype).tiny, gamma0.dtype)
    thresh = jnp.maximum(tol * tol * gamma_ref, eps_floor)

    def cond(state):
        _, _, _, _, gamma, _, gamma_best, k = state
        unconverged = gamma > thresh
        progressing = gamma <= 1e4 * gamma_best
        return jnp.logical_and(
            jnp.any(unconverged),
            jnp.logical_and(jnp.any(jnp.logical_and(unconverged,
                                                    progressing)),
                            k < maxiter))

    def body(state):
        x, r, s, p, gamma, x_best, gamma_best, k = state
        q = matvec(p)
        qq = jnp.sum(q * q, axis=0)
        alpha = jnp.where(qq > 0, gamma / jnp.where(qq > 0, qq, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * q
        s = rmatvec(r)
        gamma_new = jnp.sum(s * s, axis=0)
        improved = gamma_new < gamma_best
        x_best = jnp.where(improved[None, :], x, x_best)
        gamma_best = jnp.where(improved, gamma_new, gamma_best)
        beta = jnp.where(gamma > 0, gamma_new / jnp.where(gamma > 0,
                                                          gamma, 1.0), 0.0)
        p = s + beta * p
        return x, r, s, p, gamma_new, x_best, gamma_best, k + 1

    _, _, _, _, _, x, gamma, k = jax.lax.while_loop(
        cond, body, (x0b, r0, s0, s0, gamma0, x0b, gamma0, jnp.int32(0)))
    return (x[:, 0] if vec else x), k, gamma


def _pcg(op: Callable, bb: jax.Array, *, pinv: Optional[Callable] = None,
         x0: Optional[jax.Array] = None, tol: float, maxiter: int
         ) -> Tuple[jax.Array, jax.Array]:
    """CG on the SPD system ``op(x) = bb``, optionally preconditioned by
    ``pinv`` and warm-started at ``x0``; block right-hand sides get
    per-column step sizes. Shared core of min_norm_lsq and nystrom_pcg
    (cgls keeps its own loop — its residual lives in normal-equation
    space). Returns ``(x, iterations)``.

    Stopping is on the UNPRECONDITIONED residual ||r|| relative to
    ||b|| (zero-start): the preconditioned quantity <r, P^-1 r> is used
    only for step sizes, because for near-singular preconditioner
    spectra it is computed by catastrophic cancellation and its sign at
    rounding level is meaningless (see nystrom_pcg's degenerate-tail
    handling). Same divergence guard as cgls: the best iterate per
    column is what gets returned, and the loop exits once every
    unconverged column has drifted far above its own best residual.
    """
    x_init = jnp.zeros_like(bb) if x0 is None else x0
    r0 = bb if x0 is None else bb - op(x_init)
    z0 = r0 if pinv is None else pinv(r0)
    gamma0 = jnp.sum(r0 * z0, axis=0)
    rho0 = jnp.sum(r0 * r0, axis=0)
    eps_floor = jnp.asarray(jnp.finfo(bb.dtype).tiny, rho0.dtype)
    # reference is the zero-start residual ||b||^2 even when warm-started
    # (the cgls lesson: thresholds relative to a good warm start are
    # unreachable and CG past machine precision diverges)
    thresh = jnp.maximum(tol * tol * jnp.sum(bb * bb, axis=0), eps_floor)

    def cond_fn(st):
        _, _, _, _, _, rho, _, rho_best, k = st
        unconverged = rho > thresh
        progressing = rho <= 1e4 * rho_best
        return jnp.logical_and(
            jnp.any(unconverged),
            jnp.logical_and(jnp.any(jnp.logical_and(unconverged,
                                                    progressing)),
                            k < maxiter))

    def body_fn(st):
        x, r, z, p, gamma, _, x_best, rho_best, k = st
        q = op(p)
        pq = jnp.sum(p * q, axis=0)
        alpha = jnp.where(pq > 0, gamma / jnp.where(pq > 0, pq, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * q
        z = r if pinv is None else pinv(r)
        gamma_new = jnp.sum(r * z, axis=0)
        rho_new = jnp.sum(r * r, axis=0)
        improved = rho_new < rho_best
        x_best = jnp.where(improved[None, :], x, x_best)
        rho_best = jnp.where(improved, rho_new, rho_best)
        beta = jnp.where(gamma > 0,
                         gamma_new / jnp.where(gamma > 0, gamma, 1.0), 0.0)
        p = z + beta * p
        return x, r, z, p, gamma_new, rho_new, x_best, rho_best, k + 1

    _, _, _, _, _, _, x, _, iters = jax.lax.while_loop(
        cond_fn, body_fn,
        (x_init, r0, z0, z0, gamma0, rho0, x_init, rho0, jnp.int32(0)))
    return x, iters


def _sketch_pair(a, b, d: int, state: RNGState, operator: str,
                 vec_nnz: int, dtype, mesh=None):
    """(S A, S b, next_state) with one shared operator for A and b.
    b=None skips the right-hand-side sketch (returns sb=None) — the
    cold-start preconditioner only needs R from qr(S A).

    With ``mesh``, the sketch runs through the parallel layer: A stays
    m-sharded over 'data', each device generates its counter-addressed
    tile of the one global operator (or holds its slice of the SASO
    triplets), and the only collective is the contraction psum —
    'gaussian' and 'saso' families, dense data (plus 'gaussian' over
    sparse data via distributed_sketch_sparse_data). The SRHT family is
    column-sharded only (cross-device butterflies documented out in
    parallel/distributed.py), so it rejects a mesh here.
    """
    m = a.shape[0]
    if mesh is not None:
        return _sketch_pair_distributed(a, b, d, state, operator,
                                        vec_nnz, dtype, mesh)
    if dtype is None and operator != "saso":
        dtype = a.dtype if not _is_sparse(a) else (
            b.dtype if b is not None else jnp.float32)
    S = make_embedding(operator, d, m, state, vec_nnz=vec_nnz,
                       dtype=dtype or jnp.float32)
    bb = None if b is None else (b[:, None] if b.ndim == 1 else b)
    if _is_sparse(a):
        if operator == "saso":
            # sparse operator x sparse data has no library core (neither
            # does the reference); d x m is small — densify the OPERATOR
            # and ride the sparse-data SpMM: S @ A = (A^T @ S^T)^T.
            st = S.materialize().astype(a.vals.dtype if bb is None
                                        else bb.dtype)       # (d, m)
            sa = _apply_t(a, st.T).T                         # (d, n)
            sb = None if bb is None else st @ bb
        elif operator == "srht":
            require(False, "the SRHT embedding needs dense data "
                           "(the Hadamard transform has no sparse apply); "
                           "use 'saso' or 'gaussian' for sparse a")
        else:
            sa = sketch_sparse(S, a)
            sb = None if bb is None else sketch_general(S, bb)
    else:
        sa = sketch_general(S, a.astype(dtype) if dtype is not None else a)
        sb = None if bb is None else sketch_general(S, bb.astype(sa.dtype))
    return sa, None if sb is None else sb.astype(sa.dtype), S.next_state


def _sketch_pair_distributed(a, b, d: int, state: RNGState, operator: str,
                             vec_nnz: int, dtype, mesh):
    """Mesh-sharded _sketch_pair (see its docstring)."""
    from ..parallel import (distributed_sketch, distributed_sparse_sketch,
                            distributed_sketch_sparse_data)
    require(operator in ("saso", "gaussian"),
            "mesh-distributed sketching supports the 'saso' and "
            "'gaussian' families (SRHT is column-sharded only; see "
            "parallel/distributed.py)")
    m = a.shape[0]
    bb = None if b is None else (b[:, None] if b.ndim == 1 else b)
    if _is_sparse(a):
        require(operator == "gaussian",
                "sparse data on a mesh rides the dense-operator "
                "distributed lsksp3 (use operator='gaussian')")
        # dtype default matches the non-mesh path: the rhs dtype (an f64
        # solve must not silently downgrade the operator to f32)
        S = make_embedding("gaussian", d, m, state,
                           dtype=dtype or (bb.dtype if bb is not None
                                           else jnp.float32))
        sa = distributed_sketch_sparse_data(S, a, mesh)
        sb = None if bb is None else distributed_sketch(
            S, bb.astype(sa.dtype), mesh)
        return sa, sb, S.next_state
    if dtype is None and operator != "saso":
        dtype = a.dtype
    S = make_embedding(operator, d, m, state, vec_nnz=vec_nnz,
                       dtype=dtype or jnp.float32)
    if operator == "saso":
        # honor an explicit dtype like the non-mesh path (an f64 solve
        # must not silently run an f32 sketch on the mesh)
        adt = a.astype(dtype) if dtype is not None else a
        sa = distributed_sparse_sketch(S, adt, mesh)
        sb = None if bb is None else distributed_sparse_sketch(
            S, bb.astype(sa.dtype), mesh)
    else:
        adt = a.astype(dtype) if dtype is not None else a
        sa = distributed_sketch(S, adt, mesh)
        sb = None if bb is None else distributed_sketch(
            S, bb.astype(sa.dtype), mesh)
    return sa, sb, S.next_state


def sketch_and_solve_lsq(a, b, d: int, state: RNGState, *,
                         operator: str = "saso", vec_nnz: int = 8,
                         dtype=None, mesh=None
                         ) -> Tuple[jax.Array, RNGState]:
    """Delta-accurate least squares: x = argmin ||S A x - S b||.

    ``a`` is tall (m, n) dense or sparse (COO/CSR/CSC); ``b`` is (m,) or
    (m, k); ``d`` is the sketch size (2n..4n gives the classic
    (1+delta) residual guarantees); ``operator`` picks the embedding
    family ('saso' | 'gaussian' | 'srht'). With ``mesh``, the sketch
    runs distributed with A m-sharded over 'data' ('saso'/'gaussian';
    see _sketch_pair). Returns (x, next_state).
    """
    m, n = a.shape
    require(m >= n, "sketch_and_solve_lsq expects a tall system (m >= n)")
    require(n <= d <= m, "sketch size d must satisfy n <= d <= m")
    sa, sb, nxt = _sketch_pair(a, b, d, state, operator, vec_nnz, dtype,
                               mesh=mesh)
    q, r = jnp.linalg.qr(sa)
    x = jax.scipy.linalg.solve_triangular(r, q.T @ sb, lower=False)
    return (x[:, 0] if b.ndim == 1 else x), nxt


def sketch_and_precondition(a, b, state: RNGState, *, d: Optional[int] = None,
                            operator: str = "saso", vec_nnz: int = 8,
                            tol: Optional[float] = None, maxiter: int = 200,
                            warm_start: bool = True, dtype=None, mesh=None
                            ) -> Tuple[jax.Array, jax.Array, RNGState]:
    """Solver-accurate least squares via sketched preconditioning.

    Sketch A to d ~ 2n rows (``operator``: 'saso' | 'gaussian' | 'srht'
    — 'srht' is the classic Blendenpik transform), QR the sketch, run
    CGLS on the full problem in the preconditioned variable y = R x
    (cond(A R^-1) = O(1) whp). ``warm_start`` seeds the iteration with
    the sketch-and-solve solution, which typically saves ~1/3 of the
    iterations for free (the sketch and its QR are already paid for).

    Returns ``(x, cgls_iterations, next_state)``. For ill-conditioned
    systems run under float64 (jax.config.update("jax_enable_x64",
    True)).

    With ``mesh``, A stays m-sharded over the mesh's 'data' axis through
    BOTH phases: the preconditioner sketch runs through the parallel
    layer (implicit operator tiles per device, psum-only contraction),
    and the CGLS matvecs ride XLA's sharding propagation.
    """
    m, n = a.shape
    require(m >= n, "sketch_and_precondition expects a tall system")
    d = 2 * n if d is None else d
    d = min(d, m)
    require(d >= n, "sketch size d must be >= n")

    if warm_start:
        sa, sb, nxt = _sketch_pair(a, b, d, state, operator, vec_nnz,
                                   dtype, mesh=mesh)
        q, r = jnp.linalg.qr(sa)
        y0 = q.T @ sb                         # R x_sketched, in y variables
    else:
        # cold start needs only R: skip the b sketch and the Q factor
        sa, _, nxt = _sketch_pair(a, None, d, state, operator, vec_nnz,
                                  dtype, mesh=mesh)
        r = jnp.linalg.qr(sa, mode="r")
        y0 = None
    solve_r = lambda v: jax.scipy.linalg.solve_triangular(r, v, lower=False)
    solve_rt = lambda v: jax.scipy.linalg.solve_triangular(
        r.T, v, lower=True)

    bb = b if b.ndim > 1 else b[:, None]
    y, iters, _ = cgls(
        lambda y: _apply(a, solve_r(y)),
        lambda rr: solve_rt(_apply_t(a, rr)),
        bb.astype(sa.dtype), n, x0=y0, tol=tol, maxiter=maxiter)
    x = solve_r(y)
    return (x[:, 0] if b.ndim == 1 else x), iters, nxt


def min_norm_lsq(a, b, state: RNGState, *, d: Optional[int] = None,
                 operator: str = "saso", vec_nnz: int = 8,
                 tol: Optional[float] = None, maxiter: int = 200,
                 dtype=None) -> Tuple[jax.Array, jax.Array, RNGState]:
    """Minimum-norm solution of the WIDE consistent system ``A x = b``
    (m < n): ``x = A^T (A A^T)^+ b`` — the underdetermined counterpart
    of sketch_and_precondition (the LSRN family's second case).

    Preconditioning runs on the tall dual ``B = A^T`` (n, m): QR of the
    sketched dual ``S B`` gives R with cond(B R^-1) = O(1), so CG on the
    substituted Gram system

        (B R^-1)^T (B R^-1) z = R^-T b,    y = R^-1 z,    x = B y

    converges in O(1) iterations independent of cond(A); each step costs
    one A and one A^T product (rides the fused/SpMM dispatch) plus two
    m x m triangular solves. ``b`` is (m,) or (m, k). Returns
    ``(x, iterations, next_state)``.

    Accuracy: the SOLUTION error ||x - x*|| reaches ~100*eps of the
    working dtype regardless of cond(A) (the preconditioned system is
    O(1)-conditioned), but the residual ||A x - b|| amplifies x-error by
    sigma_max, i.e. holds only to ~cond(A)*eps. Run under float64 when
    the residual itself must be small.
    """
    m, n = a.shape
    require(m <= n, "min_norm_lsq expects a wide system (m <= n); "
                    "use sketch_and_precondition for tall systems")
    d = 2 * m if d is None else d
    d = min(d, n)
    require(d >= m, "sketch size d must be >= m")

    # sketch the dual: S (d, n) applied to B = A^T, i.e. (S applied from
    # the left of A^T) == sketching A from the RIGHT then transposing.
    if _is_sparse(a):
        require(operator != "srht", "the SRHT embedding needs dense data")
        sdtype = dtype or (b.dtype if hasattr(b, "dtype") else jnp.float32)
        S = make_embedding(operator, d, n, state, vec_nnz=vec_nnz,
                           dtype=sdtype)
        if operator == "gaussian":
            # implicit-operator lsksp3 on the transposed data view: the
            # (d, n)-with-n-LONG operator is never materialized.
            from ..sparse_data.conversions import to_coo
            sb = sketch_sparse(S, to_coo(a).transpose())    # (d, m)
        else:
            # sparse op x sparse data has no library core (neither does
            # the reference); the d x n SASO densification is the
            # documented cost of 'saso' on sparse data here — prefer
            # 'gaussian' when n is large.
            st = S.materialize().astype(sdtype)
            sb = _apply(a, st.T).T                          # (d, m)
        nxt = S.next_state
    else:
        S = make_embedding(operator, d, n, state, vec_nnz=vec_nnz,
                           dtype=dtype or a.dtype)
        adt = a.astype(dtype) if dtype is not None else a
        sb = sketch_general(S, adt, side="right", op_s="T").T   # (d, m)
        nxt = S.next_state
    r = jnp.linalg.qr(sb, mode="r")
    solve_r = lambda v: jax.scipy.linalg.solve_triangular(r, v, lower=False)
    solve_rt = lambda v: jax.scipy.linalg.solve_triangular(
        r.T, v, lower=True)

    bb = (b[:, None] if b.ndim == 1 else b).astype(sb.dtype)
    # CG on the substituted Gram system G z = c with
    # G = (B R^-1)^T (B R^-1) = R^-T A A^T R^-1 (cond O(1) whp) and
    # c = R^-T b; one A^T and one A product per step.
    def gmat(z):
        y = solve_r(z)                              # (m, k)
        w = _apply_t(a, y)                          # A^T y: (n, k)
        return solve_rt(_apply(a, w))               # R^-T A w: (m, k)

    c = solve_rt(bb)
    if tol is None:
        tol = 100.0 * float(jnp.finfo(bb.dtype).eps)
    z, iters = _pcg(gmat, c, tol=tol, maxiter=maxiter)
    x = _apply_t(a, solve_r(z))                     # x = A^T R^-1 z
    return (x[:, 0] if b.ndim == 1 else x), iters, nxt


def ridge_lsq(a, b, mu: float, state: RNGState, *,
              d: Optional[int] = None, operator: str = "saso",
              vec_nnz: int = 8, tol: Optional[float] = None,
              maxiter: int = 200, warm_start: bool = True,
              dtype=None, mesh=None
              ) -> Tuple[jax.Array, jax.Array, RNGState]:
    """Sketch-and-precondition ridge (Tikhonov) regression:

        x = argmin ||A x - b||^2 + mu * ||x||^2

    for tall ``a`` (m, n) dense or sparse, via CGLS on the augmented
    system ``[A; sqrt(mu) I] x ~= [b; 0]`` preconditioned by R from
    ``qr([S A; sqrt(mu) I])`` — the identity block is carried exactly
    (only A's rows need embedding), so cond of the preconditioned
    augmented operator is O(1) whp for any mu >= 0, and the iteration
    count is independent of both cond(A) and the regularization
    strength. ``mu = 0`` reduces to sketch_and_precondition (same
    operator stream: the A-sketch is identical).

    ``warm_start`` seeds CGLS with the sketched ridge solution
    ``argmin ||S A x - S b||^2 + mu ||x||^2`` (one extra d-sized sketch
    of b; the QR is already paid for). ``b`` is (m,) or (m, k);
    ``operator`` picks 'saso' | 'gaussian' | 'srht'; with ``mesh`` the
    sketch runs m-sharded through the parallel layer and the CGLS
    matvecs ride XLA's sharding propagation. Returns
    ``(x, cgls_iterations, next_state)``.

    The reference ships no regularized solver (its examples stop at TLS
    and plain sketch-and-solve); this rides the same lskge3/lsksp3
    dispatch its pipelines would.
    """
    m, n = a.shape
    require(m >= n, "ridge_lsq expects a tall system (m >= n); for wide "
                    "systems solve the dual or use nystrom_pcg on the "
                    "Gram operator")
    require(mu >= 0.0, "mu must be >= 0")
    d = 2 * n if d is None else d
    d = min(d, m)
    require(d >= n, "sketch size d must be >= n")

    sa, sb, nxt = _sketch_pair(a, b if warm_start else None, d, state,
                               operator, vec_nnz, dtype, mesh=mesh)
    dt = sa.dtype
    root_mu = jnp.sqrt(jnp.asarray(mu, dt))
    aug = jnp.concatenate([sa, root_mu * jnp.eye(n, dtype=dt)], axis=0)
    r = jnp.linalg.qr(aug, mode="r")
    solve_r = lambda v: jax.scipy.linalg.solve_triangular(r, v, lower=False)
    solve_rt = lambda v: jax.scipy.linalg.solve_triangular(
        r.T, v, lower=True)

    bb = (b[:, None] if b.ndim == 1 else b).astype(dt)
    # y = R x variables; the augmented residual splits into the data
    # block (m rows, through A) and the regularization block (n rows,
    # sqrt(mu) * x) — never materialized as one stacked matrix for A's
    # side (_apply keeps sparse data sparse), only the small n-block is
    # appended.
    def matvec(y):
        x = solve_r(y)
        return jnp.concatenate([_apply(a, x), root_mu * x], axis=0)

    def rmatvec(rr):
        return solve_rt(_apply_t(a, rr[:m]) + root_mu * rr[m:])

    b_aug = jnp.concatenate(
        [bb, jnp.zeros((n, bb.shape[1]), dt)], axis=0)
    # warm start: the sketched-ridge solution solves (R^T R) x = (SA)^T Sb,
    # i.e. y0 = R^-T (SA)^T Sb
    y0 = solve_rt(sa.T @ sb) if warm_start else None
    y, iters, _ = cgls(matvec, rmatvec, b_aug, n, x0=y0, tol=tol,
                       maxiter=maxiter)
    x = solve_r(y)
    return (x[:, 0] if b.ndim == 1 else x), iters, nxt


def ihs_lsq(a, b, state: RNGState, *, d: Optional[int] = None,
            iters: int = 24, operator: str = "saso", vec_nnz: int = 8,
            dtype=None, mesh=None) -> Tuple[jax.Array, RNGState]:
    """Iterative Hessian sketch least squares with heavy-ball momentum
    (Pilanci-Wainwright 2016; accelerated form Lacotte-Pilanci 2020).

    Solves ``min ||A x - b||`` by damped Newton steps whose Hessian is
    ONE sketched Gram, with Polyak momentum::

        u_t     = ((S A)^T (S A))^{-1} A^T (A x_t - b)
        x_{t+1} = x_t - alpha u_t + beta (x_t - x_{t-1})

    With an unbiased embedding (isometry-scaled), the preconditioned
    Hessian's spectrum sits in the Marchenko-Pastur bulk
    ``[(1+r)^-2, (1-r)^-2]``, ``r = sqrt(n/d)``, so the optimal
    heavy-ball parameters are closed-form: ``alpha = (1 - n/d)^2``,
    ``beta = n/d``, giving a DETERMINISTIC asymptotic contraction of
    ``sqrt(n/d)`` per step — ``1/2`` at the default ``d = 4 n``
    (MEASURED on all three families at (600, 40): plain unit-step IHS
    with a fresh sketch per iteration, the paper's original scheme,
    contracts at only ~0.75/step at this ``d`` because
    ``I - (W^T W)^{-1}`` has eigenvalues outside the unit disc; the
    fixed-sketch momentum form is both faster AND does d/n-times less
    sketching). Unlike :func:`sketch_and_solve_lsq` the SOLUTION error
    — not just the residual — reaches working precision (~cond(A) eps).

    Against :func:`sketch_and_precondition` (same access pattern: one
    sketch + iterations touching A): IHS needs no inner Krylov state —
    each step is two thin HIGHEST-precision products with ``A`` plus two
    (n, n) triangular solves inside one ``lax.scan``, which is why the
    paper's constrained/streamed variants reuse it. CGLS converges
    cond-independently too, so for the plain dense problem either works;
    IHS's step is the one that generalizes when the subproblem carries
    constraints.

    ``a`` is tall (m, n) dense or sparse (COO/CSR/CSC); ``b`` is (m,) or
    (m, k); ``operator`` is 'saso' | 'gaussian' | 'srht'. ``d`` defaults
    to ``4 n``; ``iters`` to 24 (0.5^24 ~ 6e-8 < f32 eps). With
    ``mesh``, the sketch and the scan's tall products run m-sharded over
    the mesh's 'data' axis (see _sketch_pair). No reference analog (the
    C++ library stops at sketch-and-solve; this is the natural member
    above it). Returns ``(x, next_state)``.
    """
    m, n = a.shape
    require(m >= n, "ihs_lsq expects a tall system (m >= n)")
    require(iters >= 1, "ihs_lsq needs at least one iteration")
    d = 4 * n if d is None else d
    d = min(d, m)
    require(d > n, "sketch size d must exceed n (d ~ 4n recommended)")

    from ..dense import isometry_scale_factor
    from .qb import _apply_precise, _mm_precise

    # the sketched Hessian must be an UNBIASED Gram estimate
    # (E[(c S)^T (c S)] = I) for the Marchenko-Pastur spectrum bounds
    # behind (alpha, beta) to hold: the library's operators are raw
    # reference-style streams, so apply the family's isometry scale.
    sa, _, st = _sketch_pair(a, None, d, state, operator, vec_nnz,
                             dtype, mesh=mesh)
    c = isometry_scale_factor(
        make_embedding(operator, d, m, state, vec_nnz=vec_nnz).dist)
    r = jnp.linalg.qr(c * sa, mode="r")

    xi = n / d
    alpha = (1.0 - xi) ** 2
    beta = xi

    bb = (b[:, None] if b.ndim == 1 else b).astype(r.dtype)

    def grad(x):
        # A^T (A x - b) at certificate precision: the update is
        # H_S^{-1} grad, so reduced-precision noise in the gradient lands in
        # the iterate and floors the achievable solution error; these
        # are thin (k-column) products, HIGHEST is bandwidth-free.
        res = _apply_precise(a, x) - bb
        if _is_sparse(a):
            return _apply_t(a, res)                     # exact gathers
        return _mm_precise(a.T, res)

    def step(carry, _):
        x, xp = carry
        g = grad(x)
        u = jax.scipy.linalg.solve_triangular(r.T, g, lower=True)
        u = jax.scipy.linalg.solve_triangular(r, u, lower=False)
        return (x - alpha * u + beta * (x - xp), x), None

    x0 = jnp.zeros((n, bb.shape[1]), r.dtype)
    (x, _), _ = jax.lax.scan(step, (x0, x0), None, length=iters)
    return (x[:, 0] if b.ndim == 1 else x), st
