"""Blocked-ELL sparse format and its SpMM: C = alpha * E @ B.

**BlockedELL**: for each (row, column-block-of-KB) pair, exactly BW slot
entries (column LOCAL to the block, value), padded with (-1, 0). BW is
the max per-(row, block) occupancy — a static property of the matrix.
Construction is a one-time host-side pass (the analog of the reference
pre-sorting COO into CSC before its apply, coo_spmm_impl.hh:98-104).

The product is plain XLA: one compare-select per slot densifies the
tables (global column = block * KB + local column, in B's storage
order) and a GEMM contracts the dense matrix with B; the two-tier
overflow entries go through the COO apply (ops/coo_apply.py). Padding
slots (column -1) match no column; duplicated (row, col) slots
accumulate, same as COO. (Scattering the flattened slot tables instead
took 23 ms on the H100 at config 4b's shape, where 12.6 M slots hold
1 M nonzeros — PERF.md.)
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..base import require


def _empty(dtype):
    return jnp.zeros((0,), dtype)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BlockedELL:
    """Slot tables: local_cols/vals have shape (n_kblocks * bw, n_rows)
    (slot-major: row r's slots for column block k are rows k*bw..k*bw+bw-1
    of the tables, column r). Static: shape, kb (column block size), bw.

    Two-tier form (bw_cap in from_ell): entries beyond slot ``bw_cap``
    of a (row, block) group live in the ``ovf_*`` COO arrays instead of
    widening bw for everyone — the one-hot build cost is m*k*bw
    regardless of how few slots are occupied, so a small bw with a thin
    segment-sum overflow pass beats paying the max occupancy everywhere
    (the analog of the reference keeping a general COO path beside the
    regular-CSC fast path, csc_spmm_impl.hh:68-88).
    """
    local_cols: jax.Array   # int32, -1 = empty slot
    vals: jax.Array         # float32
    n_rows: int = dataclasses.field(metadata={"static": True})
    n_cols: int = dataclasses.field(metadata={"static": True})
    kb: int = dataclasses.field(metadata={"static": True})
    bw: int = dataclasses.field(metadata={"static": True})
    ovf_rows: jax.Array = dataclasses.field(
        default_factory=lambda: _empty(jnp.int32))
    ovf_cols: jax.Array = dataclasses.field(
        default_factory=lambda: _empty(jnp.int32))
    ovf_vals: jax.Array = dataclasses.field(
        default_factory=lambda: _empty(jnp.float32))
    # When W > 0, the B operand's rows are expected in *word-major*
    # storage order: storage row s holds original row k with
    # s = (k % W) * ceil(n_cols / W) + k // W. This is the layout the
    # ColMajor-natural dense fill produces for free (one float per RNG
    # counter word, planes concatenated un-interleaved), so a product
    # against an implicit ColMajor operator skips the lane interleave.
    word_major: int = dataclasses.field(default=0,
                                        metadata={"static": True})

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def n_kblocks(self) -> int:
        return self.local_cols.shape[0] // self.bw

    @property
    def ovf_nnz(self) -> int:
        return self.ovf_rows.shape[0]

    @property
    def b_rows(self) -> int:
        """Expected row count of the B operand (storage order)."""
        if self.word_major:
            w = self.word_major
            return w * (-(-self.n_cols // w))
        return self.n_cols

    @staticmethod
    def from_ell(ell, kb: int = 128, ti: int = 2048,
                 bw_cap: int = None, word_major: int = 0) -> "BlockedELL":
        """One-time host-side conversion (concrete arrays required).
        Zero-valued ELL slots are treated as padding and dropped.
        bw_cap: cap the per-(row, block) slot count; excess entries go
        to the COO overflow arrays (two-tier form).
        word_major: build the tables against word-major B storage order
        (see the field docstring); pass the RNG counter width (4) when
        the B operand is an implicit ColMajor-natural dense operator."""
        cols = np.asarray(ell.colidxs)
        vals = np.asarray(ell.vals, dtype=np.float32)
        m, k = ell.shape
        m_pad = -(-max(m, 8) // ti) * ti if m >= ti else -(-m // 8) * 8
        k_store = k
        if word_major:
            k_store = word_major * (-(-k // word_major))
        k_pad = -(-k_store // kb) * kb
        n_k = k_pad // kb

        rows = np.repeat(np.arange(m, dtype=np.int64), cols.shape[1])
        c = cols.reshape(-1).astype(np.int64)
        v = vals.reshape(-1)
        keep = v != 0
        rows, c, v = rows[keep], c[keep], v[keep]
        if word_major:
            nblk = k_store // word_major
            c = (c % word_major) * nblk + c // word_major
        blk = c // kb
        key = rows * n_k + blk
        order = np.argsort(key, kind="stable")
        sk = key[order]
        starts = np.searchsorted(sk, np.arange(m * n_k))
        slot = np.arange(len(sk)) - starts[sk]

        ovf = np.zeros(0, dtype=bool)
        if bw_cap is not None and (slot >= bw_cap).any():
            ovf = slot >= bw_cap
            bw = bw_cap
        else:
            bw = int(slot.max(initial=-1)) + 1
            if bw_cap is not None:
                bw = min(max(bw, 1), bw_cap)
            else:
                bw = max(-(-bw // 8) * 8, 8)

        tab_c = np.full((m_pad, n_k * bw), -1, dtype=np.int32)
        tab_v = np.zeros((m_pad, n_k * bw), dtype=np.float32)
        if ovf.any():
            keep_t = ~ovf
            pos = blk[order][keep_t] * bw + slot[keep_t]
            tab_c[rows[order][keep_t], pos] = \
                (c[order][keep_t] % kb).astype(np.int32)
            tab_v[rows[order][keep_t], pos] = v[order][keep_t]
            o_rows = rows[order][ovf].astype(np.int32)
            # overflow columns stay in storage order — they index the
            # same (possibly word-major) operand the slot tables do
            o_cols = c[order][ovf].astype(np.int32)
            o_vals = v[order][ovf]
            return BlockedELL(jnp.asarray(tab_c.T), jnp.asarray(tab_v.T),
                              m, k, kb, bw, jnp.asarray(o_rows),
                              jnp.asarray(o_cols), jnp.asarray(o_vals),
                              word_major)
        pos = blk[order] * bw + slot
        tab_c[rows[order], pos] = (c[order] % kb).astype(np.int32)
        tab_v[rows[order], pos] = v[order]
        return BlockedELL(jnp.asarray(tab_c.T), jnp.asarray(tab_v.T),
                          m, k, kb, bw, word_major=word_major)

    def to_coo(self):
        """Host-side conversion back to COO (general-form fallback)."""
        from ..sparse_data.coo import COOMatrix
        return COOMatrix.from_dense(self.to_dense())

    def to_dense(self) -> jax.Array:
        n_k = self.n_kblocks
        ci = np.asarray(self.local_cols).T   # (m_pad, n_k*bw)
        v = np.asarray(self.vals).T
        dense = np.zeros((ci.shape[0], n_k * self.kb), np.float32)
        for b in range(n_k):
            sl = slice(b * self.bw, (b + 1) * self.bw)
            c = ci[:, sl]
            mask = c >= 0
            r, s = np.nonzero(mask)
            np.add.at(dense, (r, b * self.kb + c[r, s]), v[:, sl][r, s])
        if self.ovf_nnz:
            np.add.at(dense, (np.asarray(self.ovf_rows),
                              np.asarray(self.ovf_cols)),
                      np.asarray(self.ovf_vals))
        if self.word_major:
            # columns are in storage order: s = (k % W)*nblk + k//W
            w = self.word_major
            nblk = self.b_rows // w
            s_of_k = ((np.arange(self.n_cols) % w) * nblk
                      + np.arange(self.n_cols) // w)
            return jnp.asarray(dense[:self.n_rows, s_of_k])
        return jnp.asarray(dense[:self.n_rows, :self.n_cols])


def to_word_major_rows(b, w: int, n_cols: int):
    """Reorder a natural-row-order operand (n_cols, n) into word-major
    storage order (w*ceil(n_cols/w), n): storage row (k % w)*nblk + k//w
    holds original row k. The generic (relayout-paying) fallback for
    word-major BlockedELL products whose operand did not come from a
    plane fill."""
    b = jnp.asarray(b)
    nblk = -(-n_cols // w)
    if b.shape[0] != w * nblk:
        b = jnp.pad(b, ((0, w * nblk - b.shape[0]), (0, 0)))
    return b.reshape(nblk, w, b.shape[1]).transpose(1, 0, 2).reshape(
        w * nblk, b.shape[1])


def blocked_ell_matmul(bell: BlockedELL, b, alpha=1.0):
    """alpha * bell @ b. b: (bell.b_rows, n), float32 or bfloat16; for a
    word-major bell, b's rows must already be in storage order
    (to_word_major_rows, or a plane fill that produces that order for
    free). Returns (bell.n_rows, n) in b's dtype."""
    b = jnp.asarray(b)
    require(b.ndim == 2 and b.shape[0] == bell.b_rows,
            "operand height must equal b_rows (n_cols, or the word-major "
            "storage row count)")
    n_k, bw, kb = bell.n_kblocks, bell.bw, bell.kb
    m_pad = bell.local_cols.shape[1]
    # (row, block, slot) order, then one compare-select per slot builds
    # row r's dense columns [block*kb, (block+1)*kb) — no scatter, so no
    # cost for the padding slots beyond one compare each
    ci = bell.local_cols.reshape(n_k, bw, m_pad).transpose(2, 0, 1)
    v = bell.vals.reshape(n_k, bw, m_pad).transpose(2, 0, 1)
    col = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 1, kb), 3)
    dense = jnp.sum(jnp.where(ci[..., None] == col, v[..., None],
                              jnp.zeros((), v.dtype)), axis=2)
    dense = dense.reshape(m_pad, n_k * kb)[:bell.n_rows].astype(b.dtype)
    b_pad = jnp.pad(b, ((0, n_k * kb - b.shape[0]), (0, 0)))
    out = jnp.asarray(alpha, b.dtype) * jnp.matmul(
        dense, b_pad, preferred_element_type=b.dtype)
    if bell.ovf_nnz:
        from .coo_apply import coo_left_apply_auto
        out = out + coo_left_apply_auto(
            bell.ovf_rows, bell.ovf_cols, bell.ovf_vals.astype(b.dtype), b,
            bell.n_rows, bell.b_rows, alpha=alpha)
    return out
