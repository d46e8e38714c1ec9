"""Distributed randomized linear algebra over a device mesh.

Composes the sketching layer with mesh sharding so the WHOLE pipeline —
sketch, orthonormalize, power-iterate, compress — runs with the data
matrix's long axis sharded over devices and never gathered. The
reference has no distributed tier at all (SURVEY.md §2.3); its closest
artifact is the handrolled CholQR used by its test infrastructure
(/root/reference/test/handrolled_lapack.hh:39-307, chol_qr /
potrf_upper), which is exactly the tall-skinny QR that distributes: the
only collective a CholQR needs is the k x k Gram reduction.

Design (idiomatic JAX, no shard_map needed): the data matrix A (m, n)
lives row-sharded P('data', None) on the mesh; every algorithm step is
a matmul whose sharding XLA propagates —

  * Y = A @ Sm         row-sharded, zero communication (Sm replicated,
                        n x k is tiny next to the m-sharded A)
  * G = Y^T Y          k x k psum over 'data' (the ONE collective of a
                        CholQR pass)
  * Q = Y C^{-T}       row-sharded, local triangular solve per shard
  * Z = A^T Q          n x k all-reduce over 'data'
  * B = Q^T A          k x n all-reduce over 'data'

Q and any m-sized factor stay sharded end to end; everything replicated
is k- or n-sized. Works on any ('model','data') mesh from
parallel.make_sketch_mesh (the 'model' axis is simply unused by these
row-sharded algorithms — compose with distributed_sketch for d-sharded
sketches).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..base import require
from ..dense import DenseDist, DenseSkOp
from ..rng.state import RNGState
from .qb import _mm_precise, safe_svd


def cholqr(y: jax.Array, *, iters: int = 2, shift: float = 0.0
           ) -> Tuple[jax.Array, jax.Array]:
    """Tall-skinny QR by (iterated) Cholesky QR: ``y = q @ r``.

    CholQR2 (``iters=2``, the default) restores orthogonality to machine
    precision for cond(y) up to ~1/sqrt(eps); a single pass loses
    cond(y)^2 digits. The reference's test infrastructure hand-rolls the
    same factorization (handrolled_lapack.hh chol_qr); here it is the
    production tall-skinny QR because it is the one that distributes: on
    a row-sharded ``y`` the Gram product is the only collective (a k x k
    psum) and everything else is shard-local.

    ``shift`` > 0 adds ``shift * mean(diag(G)) * I`` to the Gram matrix
    before each factorization (shifted CholeskyQR, Fukaya et al. 2020)
    — use ~1e-6 when y may be numerically rank-deficient; the follow-up
    pass removes the shift's effect on orthogonality.

    Rank-deficiency rescue (always on): when ``y`` has exact numerical
    rank < k the unshifted Cholesky returns NaN, which would otherwise
    poison every downstream factor silently (the gathered-QR path this
    replaces completes rank-deficient bases with arbitrary orthonormal
    columns instead). Each factorization therefore also computes an
    eps-shifted Cholesky of the same k x k Gram (trivial next to the
    psum) and selects it when the plain factor is non-finite; null
    directions come out as small/junk-but-finite columns, mirroring the
    tiny trailing singular values the Householder path produces.
    """
    require(y.ndim == 2, "cholqr takes a 2-D array")
    require(iters >= 1, "iters must be >= 1")
    k = y.shape[1]
    dtype = y.dtype
    eye = jnp.eye(k, dtype=dtype)
    eps = jnp.finfo(dtype).eps
    r = None
    for _ in range(iters):
        # the Gram at full precision: a default-precision f32 product
        # runs with reduced-precision operands (TF32 on the GPU), which
        # would both degrade the factor AND swamp the eps-scale rescue
        # shift below — the exact NaN the rescue exists to prevent. f64
        # keeps the library's f64 routing.
        g = _mm(y.T, y, dtype) if dtype == jnp.float64 \
            else _mm_precise(y.T, y)
        g = 0.5 * (g + g.T)
        if shift:
            mu = shift * (jnp.trace(g) / k)
            g = g + mu * eye
        c = jnp.linalg.cholesky(g)                       # lower, G = C C^T
        mu_rescue = (100.0 * k * eps) * (jnp.trace(g) / k) \
            + jnp.asarray(jnp.finfo(dtype).tiny, dtype)
        c_rescue = jnp.linalg.cholesky(g + mu_rescue * eye)
        c = jnp.where(jnp.all(jnp.isfinite(c)), c, c_rescue)
        # y <- y C^{-T}: solve C x = y^T from the left, transpose back
        y = jax.scipy.linalg.solve_triangular(c, y.T, lower=True).T
        r = c.T if r is None else jnp.matmul(c.T, r)
    return y, r


def _mm(x, y, dtype):
    """Matmul with the linalg tier's f64 routing (skge._matmul) — same
    contract as qb._apply."""
    from ..skge import _matmul
    return _matmul(x, y, dtype)


def _materialized_probe(n: int, k: int, state: RNGState, dtype
                        ) -> Tuple[jax.Array, RNGState]:
    """Replicated (n, k) Gaussian probe S^T for the initial range sketch.

    n and k are the SHORT dimensions of the problem (the long, sharded
    axis is m), so materializing the probe costs n*k <<< the m-sharded
    data — the distributed tier's implicit-operator machinery
    (parallel.distributed) is for operators whose own axes are sharded.
    """
    S = DenseSkOp(DenseDist(n, k), state, dtype=dtype)
    return S.materialize(), S.next_state


def distributed_rangefinder(a: jax.Array, k: int, state: RNGState,
                            mesh: Mesh, *, power_iters: int = 2,
                            dtype=jnp.float32, cholqr_iters: int = 2,
                            gram_shift: float = 0.0) -> jax.Array:
    """Orthonormal Q (m, k) approximating range(A), with A and Q
    row-sharded P('data', None) over ``mesh`` throughout.

    The distributed counterpart of linalg.rangefinder: same sketch +
    power iteration, but every orthonormalization is a CholQR (Gram
    psum + local solve) instead of a gathered Householder QR, so the
    m-sized iterate never leaves its shards. ``gram_shift`` forwards to
    cholqr for numerically rank-deficient sketches.
    """
    m, n = a.shape
    require(k <= min(m, n), "rank must be <= min dim")
    sm, _ = _materialized_probe(n, k, state, dtype)

    a = jax.lax.with_sharding_constraint(
        a.astype(dtype), NamedSharding(mesh, P("data", None)))

    def qfix(y):
        q, _ = cholqr(y, iters=cholqr_iters, shift=gram_shift)
        return jax.lax.with_sharding_constraint(
            q, NamedSharding(mesh, P("data", None)))

    y = _mm(a, sm, dtype)
    q = qfix(y)
    for _ in range(power_iters):
        z = _mm(a.T, q, dtype)                           # psum over 'data'
        w, _ = cholqr(z, iters=cholqr_iters, shift=gram_shift)
        y = _mm(a, w, dtype)
        q = qfix(y)
    return q


def distributed_qb(a: jax.Array, k: int, state: RNGState, mesh: Mesh, *,
                   power_iters: int = 2, dtype=jnp.float32,
                   gram_shift: float = 0.0
                   ) -> Tuple[jax.Array, jax.Array]:
    """A ~= Q @ B with Q (m, k) row-sharded and B = Q^T A (k, n)
    replicated (the k x n factor is small by construction)."""
    q = distributed_rangefinder(a, k, state, mesh,
                                power_iters=power_iters, dtype=dtype,
                                gram_shift=gram_shift)
    b = _mm(q.T, a.astype(dtype), dtype)
    return q, b


def distributed_rsvd(a: jax.Array, k: int, state: RNGState, mesh: Mesh, *,
                     power_iters: int = 2, dtype=jnp.float32,
                     gram_shift: float = 0.0, oversample: int = 8
                     ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Rank-k randomized SVD with the long axis sharded end to end.

    Returns ``(u, s, vt)``: ``u`` (m, k) row-sharded over 'data',
    ``s`` (k,) and ``vt`` (k, n) replicated. The dense SVD runs on the
    (k+p) x n factor only (qb_to_svd's shape,
    svd_rank1_plus_noise.cc:264-300); the single m-sized product
    U = Q @ Ub is shard-local. ``oversample`` extra sketch columns are
    carried through the rangefinder and truncated after the small SVD,
    the same accuracy contract as the single-device ``rsvd`` (its
    default p=8), clamped to min(A.shape) - k so k near the small
    dimension stays valid; the cholqr rescue keeps k+p > rank(A) finite.
    """
    require(k <= min(a.shape), "rank must be <= min(A.shape)")
    # clamp instead of raising: k near min(A.shape) was valid before
    # oversampling existed and must stay valid
    oversample = min(oversample, min(a.shape) - k)
    q, b = distributed_qb(a, k + oversample, state, mesh,
                          power_iters=power_iters,
                          dtype=dtype, gram_shift=gram_shift)
    ub, s, vt = safe_svd(b, full_matrices=False)
    u = _mm(q, ub[:, :k], q.dtype)
    return u, s[:k], vt[:k]


def distributed_fd(a: jax.Array, ell: int, mesh: Mesh, *,
                   dtype=jnp.float32):
    """Frequent Directions of a row-sharded matrix, by mergeability
    (GLPW16 thm 1.2): every 'data' shard runs the deterministic local
    FD pass over its OWN rows (one lax.scan inside shard_map — zero
    collectives, the covariance sketch's analog of
    distributed_sketch_cols' zero-comm layout), then the per-shard
    (ell, n) sketches are merged by one more FD pass over the stacked
    (P * ell, n) rows with the per-shard certificates summed.

    Returns a :class:`~randblas_tpu.linalg.streaming.FrequentDirections`
    holding the merged sketch: ``||A^T A - B^T B||_2 <= shrink_mass``
    holds deterministically for the FULL matrix (padding rows are zero
    and carry no Gram mass). The merged certificate is at most ~2x a
    single-stream pass's (each row is shrunk against at most two
    buffers); row partitioning across shards changes B but never the
    guarantee."""
    from .streaming import FrequentDirections, fd_pass
    m, n = a.shape
    require(a.ndim == 2, "distributed_fd takes a 2-D array")
    require(1 <= ell <= n, "need 1 <= ell <= n")
    ndev = mesh.shape["data"]
    m_pad = -(-m // ndev) * ndev
    ad = a.astype(dtype)
    if m_pad != m:
        ad = jnp.pad(ad, ((0, m_pad - m), (0, 0)))
    ad = jax.lax.with_sharding_constraint(
        ad, NamedSharding(mesh, P("data", None)))

    def body(blk):
        b, mass = fd_pass(blk, ell)
        return b, mass.reshape(1)

    sketches, masses = jax.shard_map(
        body, mesh=mesh, in_specs=P("data", None),
        out_specs=(P("data", None), P("data")))(ad)
    fd = FrequentDirections(n, ell, dtype=dtype)
    fd._shrink_mass = jnp.sum(masses).astype(dtype)
    fd.ingest(sketches)
    return fd


def _absorb_gram(r, rel2, limit_cols: int):
    """Mesh-native rank-cutoff orthonormalization: eigh of the psum'd
    k x k Gram of the (already basis-projected) residual block ``r``,
    keeping directions with eigenvalue > ``cut2`` — the distributed
    analog of krylov_rangefinder's SVD absorption (an SVD of the
    row-sharded block would gather it; the Gram reduction is the only
    collective here). The Gram squares conditioning, so ``rel2`` is the
    SQUARE of the intended RELATIVE singular-value cutoff (applied
    against the block's own largest eigenvalue — Krylov loop blocks
    scale as sigma^2 of the first block, so only a per-block relative
    cut is scale-invariant); directions at the cut carry ~sqrt(eps)
    accuracy, which the Krylov iteration's later passes refine. Returns
    ``(q, lam_max)`` with ``q`` the new orthonormal columns or None."""
    import numpy as np
    g = _mm_precise(r.T, r)
    g = 0.5 * (g + g.T)
    lam, v = jnp.linalg.eigh(g)
    lam_max = float(lam[-1])
    keep = int((np.asarray(lam) > rel2 * max(lam_max, 0.0)).sum())
    keep = min(keep, limit_cols)
    if keep == 0 or lam_max <= 0.0:
        return None, lam_max
    v_k = v[:, -keep:]
    lam_k = jnp.maximum(lam[-keep:], jnp.finfo(r.dtype).tiny)
    q = _mm_precise(r, v_k / jnp.sqrt(lam_k))
    # CholQR-style refinement pass: the eigh normalization is only
    # sqrt-of-Gram accurate (~1e-4 in f32); one more k x k Gram psum +
    # triangular solve restores machine-precision orthonormality
    g2 = _mm_precise(q.T, q)
    c = jnp.linalg.cholesky(0.5 * (g2 + g2.T))
    return jax.scipy.linalg.solve_triangular(c, q.T, lower=True).T, lam_max


def distributed_krylov_rangefinder(a: jax.Array, block: int,
                                   state: RNGState, mesh: Mesh, *,
                                   depth: int = 2, dtype=jnp.float32
                                   ) -> jax.Array:
    """Row-sharded block Krylov rangefinder (Musco-Musco 2015): the
    distributed counterpart of linalg.krylov_rangefinder, with A and
    every m-sized block P('data', None)-sharded end to end. Per depth
    step the collectives are one n x block psum (A^T q), one
    basis-width x block psum (the Gram-Schmidt coefficients), and one
    block x block Gram psum (the absorption eigh) — everything reduced
    is thin. Returns the orthonormal basis, width <= block*(depth+1)
    (the rank cutoff stops growth once the range is captured; see
    krylov_rangefinder's docstring for the reduced-precision caveat).
    """
    m, n = a.shape
    require(block >= 1, "block must be >= 1")
    require(depth >= 0, "depth must be >= 0")
    require(block * (depth + 1) <= min(m, n),
            "block * (depth+1) must be <= min(A.shape)")
    sm, _ = _materialized_probe(n, block, state, dtype)
    a = jax.lax.with_sharding_constraint(
        a.astype(dtype), NamedSharding(mesh, P("data", None)))
    shard = lambda x: jax.lax.with_sharding_constraint(
        x, NamedSharding(mesh, P("data", None)))

    y = shard(_mm(a, sm, dtype))                    # (m, block) sharded
    # scale-invariant cutoffs: each block is truncated relative to its
    # OWN dominant eigenvalue (loop blocks scale as sigma^2 while the
    # first block scales as sigma^1 — any absolute cut would truncate
    # genuine Krylov directions whenever ||A|| < 1), and the loop stops
    # when a block's post-projection Gram is a rounding ghost of its
    # pre-projection scale.
    rel = 20.0 * float(jnp.finfo(dtype).eps) * float(m) ** 0.5
    basis, _ = _absorb_gram(y, rel * rel, block)
    if basis is None:                               # A == 0
        return jnp.zeros((m, 0), dtype)
    basis = shard(basis)
    prev = basis
    for _ in range(depth):
        z = _mm(a.T, prev, dtype)                   # psum over 'data'
        y = shard(_mm(a, z, dtype))
        pre2 = float(jnp.max(jnp.sum(y * y, axis=0)))  # pre-projection
        y = y - _mm_precise(basis, _mm_precise(basis.T, y))
        y = y - _mm_precise(basis, _mm_precise(basis.T, y))
        q_new, lam_max = _absorb_gram(
            y, rel * rel, min(block, min(m, n) - basis.shape[1]))
        if q_new is None or lam_max <= (rel * rel) * pre2:
            break                                   # range captured
        prev = shard(q_new)
        basis = shard(jnp.concatenate([basis, prev], axis=1))
    return basis
