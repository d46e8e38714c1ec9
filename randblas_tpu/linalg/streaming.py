"""Single-pass and streaming sketched SVD (Tropp-Yurtsever-Udell-Cevher
2017, "Practical sketching algorithms for low-rank matrix approximation").

Every other rsvd in this package re-visits A (power/Krylov iterations).
This tier touches each entry of A exactly ONCE: two independent sketches

    Y = A @ Omega        (m, k)   range sketch
    W = Psi @ A          (l, n)   co-range sketch,  l > k

are taken in a single pass, and the approximation is recovered with A
gone:  Q = orth(Y),  B = (Psi Q)^+ W,  A ~= Q B. TYUC17 shows the extra
co-range rows (l ~ 2k+1) make the recovery stable.

The streaming form is where the framework's counter addressing pays
off: for data arriving as row blocks, Y's rows are filled per block
(rows of Y = block @ Omega) and W accumulates ``Psi[:, rows] @ block``
— and ``Psi[:, rows]`` is REGENERATED per block from counters
(fill_dense_submat), so the accumulator state is two small sketch
buffers plus two RNGStates; the operators never exist in memory.
Chunking invariance: the operator slices and the row-partitioned Y
buffer are BITWISE identical under any chunking; the W accumulator
contracts over the chunked axis, so it is reassociation-equal (f32
rounding at ~1e-5), like any split reduction (the reference's
updates.rst streaming scenarios, taken to their conclusion).

Reference analog: none — the reference ships the submatrix fill
machinery (dense_skops.hh:487-532) that makes this possible but no
streaming consumer.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..base import require
from ..dense import DenseDist, DenseSkOp, fill_dense_submat
from ..rng.state import RNGState
from .qb import _apply, _is_sparse, _orth, qr_clipped_lstsq, safe_svd


def _sketch_dims(m: int, n: int, rank: int, oversample: int,
                 corange_factor: float):
    """Shared (k, l) derivation for the one-pass pair — StreamingSketch
    and single_pass_svd MUST agree bitwise (DenseDist(l, m) determines
    both the Psi stream and the seed chain)."""
    require(rank >= 1, "rank must be >= 1")
    k = rank + oversample
    l = min(int(corange_factor * k) + 1, m)
    require(k <= min(m, n), "rank + oversample must be <= min dims")
    require(l > k, "the co-range sketch needs l > k rows (TYUC17): "
                   "raise corange_factor or lower rank + oversample")
    return k, l


def _recover(y, w, psi_full, rank, dtype):
    """TYUC17 recovery: Q = orth(Y); B solves (Psi Q) B = W."""
    q = _orth(y, "qr")                      # (m, k); Householder — the
    # single-pass Y has no refinement passes to absorb CholQR's
    # rank-deficiency junk, so use the unconditionally stable QR here
    pq = jnp.matmul(psi_full, q,
                    precision=jax.lax.Precision.HIGHEST)    # (l, k)
    b = qr_clipped_lstsq(pq, w)             # (k, n)
    ub, s, vt = safe_svd(b, full_matrices=False)
    # thin basis rotation: reduced-precision default rounding here puts
    # its relative error directly on U (and thus on Q B) — HIGHEST is free
    u = jnp.matmul(q, ub[:, :rank],
                   precision=jax.lax.Precision.HIGHEST)
    return u, s[:rank], vt[:rank, :]


class StreamingSketch:
    """One-pass sketch accumulator for row-streamed data.

    ``update(row_start, block)`` may be called for any partition of the
    rows, in any order, each row exactly once; ``finalize()`` returns
    the rank-``rank`` SVD. The two operators are implicit: Omega is
    materialized once ((n, k) — small), Psi's column slice is
    counter-addressed per block, so state is O((m + n) * k) regardless
    of how A arrives.
    """

    def __init__(self, m: int, n: int, rank: int, state: RNGState, *,
                 oversample: int = 8, corange_factor: float = 2.0,
                 dtype=jnp.float32):
        k, l = _sketch_dims(m, n, rank, oversample, corange_factor)
        self.m, self.n, self.rank, self.k, self.l = m, n, rank, k, l
        self.dtype = dtype
        # two independent, seed-chained operators
        om = DenseSkOp(DenseDist(n, k), state, dtype=dtype)
        self._omega = om.materialize()                    # (n, k)
        self._psi_dist = DenseDist(l, m)
        self._psi_state = om.next_state
        S_psi = DenseSkOp(self._psi_dist, self._psi_state, dtype=dtype)
        self.next_state = S_psi.next_state
        self._y = jnp.zeros((m, k), dtype)
        self._w = jnp.zeros((l, n), dtype)
        self._seen = jnp.zeros((m,), jnp.bool_)

    def update(self, row_start: int, block) -> None:
        """Absorb rows [row_start, row_start + block.shape[0])."""
        r = block.shape[0]
        require(0 <= row_start and row_start + r <= self.m,
                "row range out of bounds")
        # overlap guard: W ACCUMULATES, so a re-submitted chunk (e.g. a
        # retried stream read) would silently double-count
        require(not bool(jnp.any(
            jax.lax.dynamic_slice(self._seen, (row_start,), (r,)))),
            "rows submitted twice (each row exactly once; W accumulates)")
        blk = block.astype(self.dtype)
        # Precision.HIGHEST on the one-pass products: these are the
        # ONLY passes over the data, so there is no refinement pass to
        # absorb reduced-precision default rounding (a 9.7e-3
        # reconstruction floor vs ~2e-3 at full f32 was measured on an
        # accelerator); they are bandwidth-bound, so full f32 is ~free.
        self._y = jax.lax.dynamic_update_slice(
            self._y, jnp.matmul(blk, self._omega,
                                precision=jax.lax.Precision.HIGHEST,
                                preferred_element_type=self.dtype),
            (row_start, 0))
        # Psi[:, rows] regenerated from counters — any chunking yields
        # the same operator slice, bitwise
        psi_cols = fill_dense_submat(self._psi_dist, self._psi_state,
                                     self.l, r, 0, row_start,
                                     dtype=self.dtype)
        self._w = self._w + jnp.matmul(psi_cols, blk,
                                       precision=jax.lax.Precision.HIGHEST,
                                       preferred_element_type=self.dtype)
        self._seen = jax.lax.dynamic_update_slice(
            self._seen, jnp.ones((r,), jnp.bool_), (row_start,))

    def finalize(self) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """(u, s, vt) of rank ``rank``. Every row must have been seen."""
        require(bool(jnp.all(self._seen)), "finalize before all rows seen")
        psi_full = fill_dense_submat(self._psi_dist, self._psi_state,
                                     self.l, self.m, 0, 0,
                                     dtype=self.dtype)
        return _recover(self._y, self._w, psi_full, self.rank, self.dtype)


from functools import partial


@partial(jax.jit, static_argnums=1)
def _fd_shrink_jit(buf: jax.Array, ell: int):
    """One FD shrink of the (2*ell, n) buffer via the Gram
    eigendecomposition (see FrequentDirections._shrink). Returns the
    shrunk buffer (top ell rescaled directions, rest exact zeros) and
    the sigma_ell^2 offset."""
    hi = jax.lax.Precision.HIGHEST
    g = jnp.matmul(buf, buf.T, precision=hi,
                   preferred_element_type=buf.dtype)
    evals, u = jnp.linalg.eigh(g)
    lam = jnp.maximum(evals[::-1][:ell], 0.0)        # descending
    uu = u[:, ::-1][:, :ell]                         # (2*ell, ell)
    delta = lam[ell - 1]                             # sigma_ell^2
    w = jnp.matmul(uu.T, buf, precision=hi,
                   preferred_element_type=buf.dtype)
    # rows of w are sigma_i v_i^T; rescale to sqrt(sigma_i^2 - delta)
    scale = jnp.sqrt(jnp.maximum(lam - delta, 0.0)
                     / jnp.maximum(lam, jnp.finfo(buf.dtype).tiny))
    top = scale[:, None] * w
    new_buf = jnp.zeros_like(buf).at[:ell, :].set(top)
    return new_buf, delta


class FrequentDirections:
    """Frequent Directions (Liberty 2013 / Ghashami–Liberty–Phillips–
    Woodruff 2016): the DETERMINISTIC streaming matrix sketch — the
    worst-case-guaranteed sibling of :class:`StreamingSketch`'s
    randomized one-pass sketch.

    Maintains ``B`` with at most ``ell`` live rows such that after any
    prefix of the row stream

        0 <= ||A x||^2 - ||B x||^2 <= ||A||_F^2 / ell   (unit x),

    i.e. ``||A^T A - B^T B||_2 <= ||A||_F^2 / ell`` — no probability of
    failure, any adversarial row order. The data-dependent bound is
    tighter: the error is at most :attr:`shrink_mass`, the running sum
    of the shrink offsets sigma_ell^2 (GLPW16 thm 1.1), which this
    class tracks so callers get an a-posteriori certificate for free.

    Shape choices: rows accumulate into a fixed (2*ell, n) buffer
    (static shapes, one `dynamic_update_slice` per chunk) and the
    shrink step is one eigendecomposition of the buffer's (2*ell,
    2*ell) Gram matrix (see ``_shrink`` for why not a thin SVD of the
    buffer itself) — GEMM-shaped batch work every `ell` rows
    instead of per-row Givens updates.
    Like ``StreamingSketch.update``, streaming is host-driven (chunk
    sizes are host decisions); everything per-chunk is device work.

    Use FD when a deterministic guarantee or adversarial streams
    matter; use StreamingSketch/single_pass_svd when a (cheaper)
    randomized guarantee is fine and you want the SVD factors, not a
    covariance sketch.
    """

    def __init__(self, n: int, ell: int, dtype=jnp.float32):
        require(ell >= 1, "ell must be >= 1")
        require(ell <= n, "ell > n is never useful: ell = n rows "
                          "already represent A^T A exactly")
        self.n, self.ell = n, ell
        self.dtype = dtype
        self._buf = jnp.zeros((2 * ell, n), dtype)
        self._fill = 0                       # host-known live row count
        # sum of sigma_ell^2 offsets — kept ON DEVICE: a float() here
        # would force a blocking host round trip per shrink, which
        # serializes the whole stream against device latency
        self._shrink_mass = jnp.zeros((), dtype)

    @property
    def shrink_mass(self):
        """Running sum of shrink offsets sigma_ell^2 — the a-posteriori
        FD error certificate (device scalar; float() it to read)."""
        return self._shrink_mass

    def _shrink(self) -> None:
        """Subtract sigma_ell^2 from the buffer's squared spectrum and
        keep the top ell directions (the rest become exact zeros).

        Implemented through the (2*ell, 2*ell) Gram eigendecomposition
        rather than an SVD of the buffer: FD's shrink lives entirely in
        sigma^2 space, so the Gram route is exact for the algorithm,
        and it is the difference between one Gram GEMM + a small eigh +
        one GEMM and a (2*ell, n) SVD. The Gram's
        squared condition only blurs eigenvalues at the eps * sigma_1^2
        scale — precisely the mass the shrink discards anyway; the
        subtraction itself is clipped at zero. Products run at HIGHEST
        (cancellation-sensitive), and eigh is ascending, so the top ell
        pairs are the reversed tail. The whole shrink is one jitted
        dispatch and stays async — nothing here touches the host."""
        self._buf, delta = _fd_shrink_jit(self._buf, self.ell)
        self._fill = self.ell
        self._shrink_mass = self._shrink_mass + delta

    def update(self, block) -> None:
        """Absorb a (r, n) block of rows (any r >= 1), shrinking
        whenever the buffer fills."""
        block = jnp.atleast_2d(block).astype(self.dtype)
        require(block.shape[1] == self.n, "block must have n columns")
        r = block.shape[0]
        off = 0
        while off < r:
            space = 2 * self.ell - self._fill
            if space == 0:
                self._shrink()
                continue
            take = min(space, r - off)
            self._buf = jax.lax.dynamic_update_slice(
                self._buf, jax.lax.dynamic_slice(
                    block, (off, 0), (take, self.n)),
                (self._fill, 0))
            self._fill += take
            off += take

    def ingest(self, a: jax.Array) -> None:
        """Absorb ALL rows of a device-resident (M, n) matrix in ONE
        jitted dispatch chain (a ``lax.scan`` over ell-row chunks).

        Bit-identical to ``update(a)`` — same chunk boundaries as an
        ell-at-a-time update loop, so the shrink sequence is the same
        — but without one host round trip per chunk: the host-driven
        update loop pays one dispatch per chunk, while the device work
        per shrink is small; ingest collapses that to a single
        dispatch. Use ``update`` when rows genuinely arrive
        over time; use ``ingest`` when the matrix (or a large slab of
        the stream) is already on device.
        """
        a = jnp.atleast_2d(a).astype(self.dtype)
        require(a.shape[1] == self.n, "matrix must have n columns")
        rows = a.shape[0]
        ell = self.ell
        # lead-in: top the buffer up to the fill == ell invariant the
        # scan maintains (handles a partially-filled buffer and the
        # empty start)
        lead = min(rows, max(0, 2 * ell - self._fill))
        if lead:
            self.update(a[:lead])
        rest = rows - lead
        if rest and self._fill == 2 * ell:
            # exactly what update() would do at the next arriving row
            self._shrink()
        nfull = rest // ell
        if nfull:
            chunks = a[lead:lead + nfull * ell].reshape(nfull, ell,
                                                        self.n)

            def step(carry, chunk):
                buf, mass = carry
                buf = jax.lax.dynamic_update_slice(buf, chunk, (ell, 0))
                buf, delta = _fd_shrink_jit(buf, ell)
                return (buf, mass + delta), None

            (self._buf, self._shrink_mass), _ = jax.lax.scan(
                step, (self._buf, self._shrink_mass), chunks)
            self._fill = ell
        tail = rest - nfull * ell
        if tail:
            self.update(a[rows - tail:])

    def sketch(self) -> jax.Array:
        """The (ell, n) sketch B. Shrinks first if more than ell rows
        are live, so the returned B always satisfies the FD guarantee
        with ell rows."""
        if self._fill > self.ell:
            self._shrink()
        return self._buf[:self.ell, :]

    def merge(self, other: "FrequentDirections") -> None:
        """Absorb another FD sketch built from DISJOINT rows — FD is a
        mergeable summary (GLPW16 thm 1.2 / Agarwal et al. 2012): if
        self summarizes A1 and other summarizes A2, after the merge
        self satisfies the FD guarantee for [A1; A2] with certificate
        self.shrink_mass = mass1 + mass2 + (masses of the merge's own
        shrinks). Implementation: other's shrunk rows stream into this
        buffer like any data block; the certificates add. ``other`` is
        shrunk to its live sketch as a side effect (``other.sketch()``);
        ``other.ell`` need not equal ``self.ell`` — the error budgets
        simply add whatever each side accumulated."""
        require(isinstance(other, FrequentDirections),
                "merge takes another FrequentDirections")
        require(other.n == self.n, "merge needs matching column counts")
        self.update(other.sketch().astype(self.dtype))
        self._shrink_mass = (self._shrink_mass
                             + other._shrink_mass.astype(self.dtype))


def fd_pass(a: jax.Array, ell: int):
    """Pure-function Frequent Directions over ALL rows of ``a`` (M, n):
    returns ``(B (ell, n), shrink_mass scalar)`` — the same shrink
    sequence as ``FrequentDirections(n, ell).ingest(a)`` followed by
    ``sketch()`` (ell-row chunks, shrink per full buffer; a ragged tail
    rides a zero-padded final chunk, which changes nothing — zero rows
    carry no Gram mass).

    This is the FD kernel distributed consumers map over shards
    (linalg.distributed.distributed_fd): no Python-object state, fully
    jittable, safe inside shard_map/scan."""
    require(ell >= 1, "ell must be >= 1")
    m, n = a.shape
    nchunks = max(1, -(-m // ell))
    pad = nchunks * ell - m
    ap = jnp.pad(a, ((0, pad), (0, 0))) if pad else a
    chunks = ap.reshape(nchunks, ell, n)
    buf = jnp.zeros((2 * ell, n), a.dtype).at[:ell, :].set(chunks[0])
    # data-derived zero: under shard_map the scan carry must keep the
    # same varying-mesh-axes type as the shrink deltas it accumulates
    # (a literal jnp.zeros is axis-UNvarying and the carry types clash)
    mass = (ap[0, 0] * 0).astype(a.dtype)
    if nchunks == 1:
        return buf[:ell, :], mass

    def step(carry, chunk):
        b, ms = carry
        b = jax.lax.dynamic_update_slice(b, chunk, (ell, 0))
        b, delta = _fd_shrink_jit(b, ell)
        return (b, ms + delta), None

    (buf, mass), _ = jax.lax.scan(step, (buf, mass), chunks[1:])
    return buf[:ell, :], mass


def single_pass_svd(a, rank: int, state: RNGState, *,
                    oversample: int = 8, corange_factor: float = 2.0,
                    dtype=jnp.float32
                    ) -> Tuple[jax.Array, jax.Array, jax.Array, RNGState]:
    """Rank-``rank`` SVD touching A exactly once (TYUC17): use when A
    is too expensive to revisit (streaming, out-of-core, one-shot
    measurement). For in-memory A where passes are cheap, ``rsvd`` /
    ``rsvd_krylov`` (power/Krylov refinement) are strictly more
    accurate. Returns ``(u, s, vt, next_state)``.
    """
    m, n = a.shape
    k, l = _sketch_dims(m, n, rank, oversample, corange_factor)
    om = DenseSkOp(DenseDist(n, k), state, dtype=dtype)
    psi_op = DenseSkOp(DenseDist(l, m), om.next_state, dtype=dtype)
    psi = psi_op.materialize()
    if _is_sparse(a):
        from .qb import _apply_t
        y = _apply(a, om.materialize())
        w = _apply_t(a, psi.T).T                 # (Psi A) via A^T Psi^T
    else:
        ad = a.astype(dtype)
        # Precision.HIGHEST: single-pass has no refinement to absorb
        # a reduced-precision floor, and the pass is bandwidth-bound (see
        # StreamingSketch.update).
        y = jnp.matmul(ad, om.materialize(),
                       precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=dtype)
        w = jnp.matmul(psi, ad, precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=dtype)
    u, s, vt = _recover(y, w, psi, rank, dtype)
    return u, s, vt, psi_op.next_state
