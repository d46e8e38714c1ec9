"""Randomized Gram-Schmidt QR (Balabanov-Grigori 2021).

``rgs_qr`` factors a tall A = QR by orthogonalizing in SKETCH space:
columns are made orthonormal with respect to the sketched inner
product <Sx, Sy> for a (d, m) subspace embedding S. Because a
(1 +- eps) embedding nearly preserves the geometry of span(A), the
resulting Q is well-conditioned (cond(Q) <= sqrt((1+eps)/(1-eps)))
even when A's condition number approaches 1/eps_machine — the regime
where CholQR's Gram matrix (cond^2) is singular in f32 and classical
GS loses orthogonality. Stability costs only sketched (d-length)
inner products instead of m-length ones.

Where it sits in the tier: `cholqr` (distributed.py) is the fast path
for the well-conditioned tall-skinny case (one Gram psum, GEMM-bound);
``rgs_qr`` is the ill-conditioned/stability path, and the natural QR
for very ill-conditioned Krylov or power-iteration bases.

Accelerator shape of the algorithm (not the paper's column loop):

- S A is computed ONCE through the fused sketch dispatch. Sketching is
  linear, so the sketched panels never need re-sketching: every
  projection update happens to the (d, k) sketch copy in lockstep with
  the (m, k) full copy.
- Columns are processed in PANELS of ``block`` (one lax.scan): two
  CGS2-style projection passes against the finished basis — exact in
  sketch space because the sketched basis SQ is EXACTLY orthonormal by
  construction (Q_panel = P Rs^{-1} gives S Q_panel = Qs from
  qr(S P), to roundoff) — then the panel is orthonormalized by the
  tiny (d, block) QR. All m-length work is GEMMs against the
  (m, k) buffer; the only small-op per panel is one (d, block) QR.
- The growing basis lives in FIXED (m, k) / (d, k) buffers whose
  unfilled columns are zero: projections against zero columns are
  exactly zero, so the scan has static shapes with no masking logic.

Reference: RandBLAS ships the embeddings; this is a library-tier
consumer in the spirit of its examples (cf. the power-iteration
stabilizers at examples/sparse-low-rank-approx/qrcp_matrixmarket.cc).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..base import require
from ..rng.state import RNGState
from ..skge import sketch_general
from .embed import make_embedding

_HI = jax.lax.Precision.HIGHEST


def _clip_triangular(r: jax.Array) -> jax.Array:
    """Floor |diag(R)| at eps*||R||_F (sign-preserving) so the panel
    solve stays finite on rank-deficient panels — same smooth-clip role
    as qr_clipped_lstsq (qb.py). A clipped direction's Q column is
    ~zero data over a floored scale: bounded, and the final CholQR pass
    (final='orth') redistributes it; exact reconstruction of the LIVE
    directions is unaffected."""
    dr = jnp.diagonal(r)
    floor = jnp.maximum(jnp.finfo(r.dtype).eps * jnp.linalg.norm(r),
                        jnp.finfo(r.dtype).tiny)
    dr_c = jnp.where(jnp.abs(dr) < floor,
                     jnp.where(dr < 0, -floor, floor), dr)
    return r + jnp.diag(dr_c - dr)


def _rgs_panel_step(q_buf, sq_buf, r_buf, a_panel, sa_panel, col0):
    """Orthogonalize one (m, b) panel against the filled prefix of the
    buffers (columns [0, col0)) and write columns [col0, col0+b).
    Unfilled buffer columns are zero, so the full-buffer GEMMs are
    exact projections against the finished basis only."""
    b = a_panel.shape[1]
    col0 = jnp.asarray(col0, jnp.int32)
    zero = jnp.zeros((), jnp.int32)
    p, sp = a_panel, sa_panel
    coeff = jnp.zeros((q_buf.shape[1], b), q_buf.dtype)
    # two passes: CGS2's "twice is enough" — SQ is orthonormal, so each
    # pass multiplies the projection residual by ~eps
    for _ in range(2):
        c = jnp.matmul(sq_buf.T, sp, precision=_HI)
        p = p - jnp.matmul(q_buf, c, precision=_HI)
        sp = sp - jnp.matmul(sq_buf, c, precision=_HI)
        coeff = coeff + c
    qs, rs = jnp.linalg.qr(sp)                     # (d, b), (b, b)
    rs = _clip_triangular(rs)
    # Q_panel = P @ Rs^{-1}: transpose-solve keeps it one triangular op
    q_panel = jax.scipy.linalg.solve_triangular(
        rs, p.T, trans=1, lower=False).T
    q_buf = jax.lax.dynamic_update_slice(q_buf, q_panel, (zero, col0))
    sq_buf = jax.lax.dynamic_update_slice(sq_buf, qs, (zero, col0))
    # R columns [col0, col0+b): projection coefficients on top of the
    # panel's own triangle. coeff rows at/below col0 are exactly zero
    # (zero basis columns), so writing coeff then rs never clobbers.
    r_buf = jax.lax.dynamic_update_slice(r_buf, coeff, (zero, col0))
    r_buf = jax.lax.dynamic_update_slice(r_buf, rs, (col0, col0))
    return q_buf, sq_buf, r_buf


# dense-materialization footprint cap for _precise_sketch (elements);
# module-level so tests can shrink it to drive the large-m branches
_FOOTPRINT_CAP = 1 << 27


def _precise_sketch(S, a: jax.Array, scale: float) -> jax.Array:
    """scale * S @ a at FULL f32 precision (Precision.HIGHEST GEMMs on
    materialized operator chunks).

    RGS is the one consumer whose CORRECTNESS depends on sketch
    fidelity: the full-space basis is built from sketch-space
    coefficients, so sketch noise at delta * ||A|| wipes out every
    singular direction below delta — and an accelerator's default
    sketch paths contract at reduced precision (TF32 on the GPU). Caught
    ON CHIP by the hardware tier's test_rgs_qr_on_hardware at cond 3e7:
    the interpret/CPU tiers ran the sketch in f32 and passed while a
    compiled reduced-precision sketch produced a garbage basis (the CPU
    repro: bf16-rounding SA alone turns orth ~1e-6 into NaN). The
    preconditioner consumers (sketch_and_precondition, sgmres) tolerate
    reduced-precision sketches by construction — their iterates touch the TRUE A —
    so this precise path is local to RGS, not a dispatch-wide change.

    Structured families stay structured: SRHT applies its Hadamard
    stages at HIGHEST precision (never materialized), and a SASO beyond
    the 2^27-element dense-footprint cap routes through the exact
    segment-sum apply (pure f32 adds of +-1-weighted rows — no GEMM, no
    materialization). Dense operators chunk over the long axis so the
    materialized block stays bounded (here d = 2k + 8 << m keeps even
    the full operator small, but chunking caps the footprint at large
    k anyway).
    """
    from ..sparse import SparseSkOp
    from ..trig import TrigSkOp

    d, m = S.shape
    k = a.shape[1]
    if isinstance(S, TrigSkOp):
        return jnp.asarray(scale, a.dtype) * S.lmult(a, precision=_HI)
    if isinstance(S, SparseSkOp):
        if d * m > _FOOTPRINT_CAP:
            from ..ops.coo_apply import fixed_nnz_left_apply
            s = S.filled()
            nnz = S.dist.vec_nnz
            sa = fixed_nnz_left_apply(s.rows.reshape(m, nnz),
                                      s.vals.reshape(m, nnz), a, d)
            return jnp.asarray(scale, a.dtype) * sa
        s_mat = S.materialize().astype(a.dtype)
        sa = jnp.matmul(s_mat, a, precision=_HI,
                        preferred_element_type=a.dtype)
        return jnp.asarray(scale, a.dtype) * sa
    chunk = m if d * m <= _FOOTPRINT_CAP else max(_FOOTPRINT_CAP // d, 1)
    if chunk >= m:
        s_mat = S.materialize().astype(a.dtype)
        sa = jnp.matmul(s_mat, a, precision=_HI,
                        preferred_element_type=a.dtype)
    else:
        sa = jnp.zeros((d, k), a.dtype)
        for c0 in range(0, m, chunk):
            mc = min(chunk, m - c0)
            blk = S.submat(d, mc, 0, c0).astype(a.dtype)
            sa = sa + jnp.matmul(blk, a[c0:c0 + mc], precision=_HI,
                                 preferred_element_type=a.dtype)
    return jnp.asarray(scale, a.dtype) * sa


def rgs_qr(a: jax.Array, state: RNGState, *, d: Optional[int] = None,
           block: int = 64, operator: str = "gaussian",
           final: str = "orth"
           ) -> Tuple[jax.Array, jax.Array, RNGState]:
    """QR of a tall matrix by randomized Gram-Schmidt (BG21).

    Returns ``(q, r, next_state)`` with ``a = q @ r`` to roundoff and
    ``r`` upper triangular.

    - ``final='orth'`` (default): one CholQR pass on the sketch-
      orthonormal basis makes Q truly orthonormal — safe because the
      basis is already well-conditioned, so its Gram is far from
      singular regardless of cond(A). Drop-in `jnp.linalg.qr`
      semantics at ill-conditioned inputs where CholQR-of-A fails.
    - ``final='sketch'``: skip the pass; Q satisfies
      (SQ)^T (SQ) = I instead, with cond(Q) <= sqrt((1+eps)/(1-eps))
      — sufficient for sketched solvers (sgmres-style) at 1/3 the
      full-length GEMM cost.

    ``d`` is the embedding dimension (default ``2k + 8``; clipped to
    m); ``operator`` picks the family ('gaussian', 'saso', 'srht').
    Requires numerically full-rank A — rank-deficient panels are
    smoothly clipped (finite output, reconstruction of the live
    directions preserved), but orthonormality of the dead directions
    is only restored by the final='orth' pass.
    """
    require(a.ndim == 2, "rgs_qr takes a matrix")
    m, k = a.shape
    require(k <= m, "rgs_qr factors TALL matrices (k <= m)")
    require(block >= 1, "block must be >= 1")
    require(final in ("orth", "sketch"),
            "final must be 'orth' or 'sketch'")
    if d is None:
        d = min(m, 2 * k + 8)
    require(k <= d <= m, "need k <= d <= m")
    block = min(block, k)

    from ..dense import isometry_scale_factor
    S = make_embedding(operator, d, m, state, dtype=a.dtype)
    # isometry scale: sketched inner products must approximate the
    # unit-scale ones, E[(cS)^T (cS)] = I
    sa = _precise_sketch(S, a, isometry_scale_factor(S.dist))

    q_buf = jnp.zeros((m, k), a.dtype)
    sq_buf = jnp.zeros((d, k), a.dtype)
    r_buf = jnp.zeros((k, k), a.dtype)

    nfull = k // block
    if nfull:
        a_panels = a[:, :nfull * block].reshape(m, nfull, block)
        sa_panels = sa[:, :nfull * block].reshape(d, nfull, block)

        def step(carry, t):
            q_b, sq_b, r_b = carry
            out = _rgs_panel_step(q_b, sq_b, r_b, a_panels[:, t],
                                  sa_panels[:, t], t * block)
            return out, None

        (q_buf, sq_buf, r_buf), _ = jax.lax.scan(
            step, (q_buf, sq_buf, r_buf),
            jnp.arange(nfull, dtype=jnp.int32))
    rem = k - nfull * block
    if rem:
        q_buf, sq_buf, r_buf = _rgs_panel_step(
            q_buf, sq_buf, r_buf, a[:, k - rem:], sa[:, k - rem:],
            k - rem)

    if final == "orth":
        # CholQR on the well-conditioned basis: Gram cond is
        # cond(Q)^2 ~ (1+eps)/(1-eps), never near singular
        g = jnp.matmul(q_buf.T, q_buf, precision=_HI)
        c = jnp.linalg.cholesky(g)
        q_buf = jax.scipy.linalg.solve_triangular(
            c, q_buf.T, lower=True).T
        r_buf = jnp.matmul(c.T, r_buf, precision=_HI)
    return q_buf, r_buf, S.next_state
