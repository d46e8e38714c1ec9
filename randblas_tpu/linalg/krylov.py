"""Randomized block Krylov low-rank approximation (Musco & Musco 2015).

Subspace (power) iteration — the reference's QB pipeline
(/root/reference/examples/sparse-low-rank-approx/
svd_rank1_plus_noise.cc:217-261) and this package's ``rangefinder`` —
needs O(log(n)/eps) passes over A for a (1+eps) spectral-norm optimal
rank-k approximation. The block Krylov iteration reaches the same
guarantee in O(log(n)/sqrt(eps)) passes by keeping EVERY intermediate
block [AS, (AA^T)AS, ..., (AA^T)^q AS] in the basis instead of only the
last one: strictly more accuracy per matvec, at the cost of a wider
(m, b*(q+1)) QR. The reference has no Krylov tier at all; this extends
its QB family the way RandLAPACK does.

Accelerator notes: each Krylov step is two GEMM-shaped products (rides
the dense/SpMM dispatch through qb._apply, including the f64 routing);
the per-step re-orthogonalization is two block Gram-Schmidt passes + one
thin QR — all (m, b)-shaped GEMM work, no host round trips.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..base import require
from ..dense import DenseDist, DenseSkOp
from ..rng.state import RNGState
from ..skge import sketch_general
from .qb import _apply, _apply_t, _is_sparse, _mm_precise, safe_svd


def krylov_rangefinder(a, block: int, state: RNGState, *, depth: int = 2,
                       dtype=jnp.float32, operator: str = "gaussian"
                       ) -> jax.Array:
    """Orthonormal basis (m, block*(depth+1)) of the block Krylov space

        K = [A S, (A A^T) A S, ..., (A A^T)^depth A S]

    for a (block)-column sketch S (Musco-Musco 2015 alg. 2). ``depth=0``
    reduces to the plain single-pass rangefinder. ``operator`` picks the
    initial sketch's embedding family like ``rangefinder`` ('gaussian' |
    'saso' | 'srht'; sparse data is 'gaussian' only).

    Each new block is orthogonalized against the accumulated basis with
    two block Gram-Schmidt passes, then absorbed through an SVD with a
    rank cutoff — by construction late Krylov blocks become nearly
    dependent on earlier ones (that is the algorithm converging), and
    plain QR of such a rank-deficient residual turns its numerically
    zero columns into only-approximately-orthogonal junk that corrupts
    the basis (see adaptive_rangefinder). The returned width is
    therefore AT MOST block*(depth+1): once A's range is captured to
    working precision the basis stops growing.

    On an accelerator the big A-products run at reduced precision (TF32
    on the GPU) for throughput, so their rounding can keep late blocks
    above the rank cutoff — the basis then reaches its full width with (orthonormal,
    harmless) noise directions rather than stopping early; the early
    stop engages under f64, on CPU, or when A's action is exact.
    """
    import numpy as np
    m, n = a.shape
    require(block >= 1, "block must be >= 1")
    require(depth >= 0, "depth must be >= 0")
    require(block * (depth + 1) <= min(m, n),
            "block * (depth+1) must be <= min(A.shape) — lower depth or "
            "the block size")
    if operator == "gaussian" or _is_sparse(a):
        require(operator == "gaussian",
                "sparse data supports only the 'gaussian' Krylov sketch "
                "(materialized thin operator through the SpMM dispatcher)")
        S = DenseSkOp(DenseDist(n, block), state, dtype=dtype)
        y = _apply(a, S.materialize())              # (m, block)
    else:
        from .embed import make_embedding
        S = make_embedding(operator, block, n, state, dtype=dtype)
        y = sketch_general(S, a.astype(dtype), side="right", op_s="T")
    # Scale-invariant rank cutoffs: loop blocks are (A A^T) prev, whose
    # singular values scale as sigma^2 while the first block scales as
    # sigma^1 — a single absolute cut would truncate genuine directions
    # whenever ||A|| < 1 (or keep junk when ||A|| > 1). Each block is
    # therefore truncated RELATIVE TO ITSELF (sr > rel * sr[0]), and the
    # loop stops when a block's post-projection content is a rounding
    # ghost of its own pre-projection scale.
    rel = 20.0 * float(jnp.finfo(dtype).eps) * float(m) ** 0.5
    ur, sr, _ = safe_svd(y, full_matrices=False)
    keep = max(1, int((np.asarray(sr) > rel * float(sr[0])).sum()))
    basis = prev = ur[:, :keep]
    for _ in range(depth):
        y = _apply(a, _apply_t(a, prev))
        pre_scale = float(jnp.max(jnp.linalg.norm(y, axis=0)))
        # projections at full precision: reduced-precision rounding of a
        # default product would leave ghosts of captured directions
        # above the rank cutoff (see qb._mm_precise)
        y = y - _mm_precise(basis, _mm_precise(basis.T, y))
        y = y - _mm_precise(basis, _mm_precise(basis.T, y))
        ur, sr, _ = safe_svd(y, full_matrices=False)
        if float(sr[0]) <= rel * pre_scale:
            break                                    # range captured
        keep = int((np.asarray(sr) > rel * float(sr[0])).sum())
        prev = ur[:, :keep]
        basis = jnp.concatenate([basis, prev], axis=1)
    return basis


def rsvd_krylov(a, rank: int, state: RNGState, *, block: int = None,
                depth: int = 2, dtype=jnp.float32,
                operator: str = "gaussian"
                ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Rank-``rank`` truncated SVD via the block Krylov rangefinder:
    returns ``(u, s, vt)``. Compared to ``rsvd(power_iters=q)`` at equal
    passes over A, the Krylov basis is strictly larger (it keeps every
    intermediate block), so the tail singular values converge in
    ~sqrt() of the iterations — the right tool for slowly decaying
    spectra where power iteration stalls. ``block`` defaults to
    ``rank + 2`` (Musco-Musco run with b ~ k).
    """
    m, n = a.shape
    require(rank >= 1, "rank must be >= 1")
    b = (rank + 2) if block is None else block
    require(b >= 1, "block must be >= 1")
    q = krylov_rangefinder(a, b, state, depth=depth, dtype=dtype,
                           operator=operator)
    bb = _apply_t(a, q).T if _is_sparse(a) else jnp.matmul(
        q.T, a.astype(dtype), preferred_element_type=dtype)
    ub, s, vt = safe_svd(bb, full_matrices=False)
    u = jnp.matmul(q, ub[:, :rank])
    s, vt = s[:rank], vt[:rank, :]
    if q.shape[1] < rank:
        # A's numerical rank is below the request (the rangefinder's
        # rank cutoff stopped the basis early): pad honestly with zero
        # singular values / vectors rather than junk directions.
        pad = rank - q.shape[1]
        u = jnp.concatenate([u, jnp.zeros((m, pad), u.dtype)], axis=1)
        s = jnp.concatenate([s, jnp.zeros((pad,), s.dtype)])
        vt = jnp.concatenate([vt, jnp.zeros((pad, n), vt.dtype)], axis=0)
    return u, s, vt
