"""ELL (ELLPACK) sparse matrices: fixed nonzeros-per-row with padding.

A fixed-width sparse-data format: a row-major (n_rows, width) table of
column indices + values, padded with zero-valued entries. Products become
pure gathers + weighted sums — no scatters, no segment reductions — which
is how irregular sparsity should meet a vector unit (SURVEY.md §7 hard
part 4: "use row/col-blocked kernels with an ELL-style padding
conversion").

The reference has no ELL type (its CPU kernels iterate CSR/CSC directly);
this container is the performance-format counterpart of those kernels'
fixed-nnz fast paths, generalized to data matrices.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..base import require


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ELLMatrix:
    """colidxs: int32[n_rows, width]; vals: float[n_rows, width].

    Padding entries have val == 0 (their column index is arbitrary but
    valid, so gathers stay in bounds).
    """
    colidxs: jax.Array
    vals: jax.Array
    n_rows: int = dataclasses.field(metadata={"static": True})
    n_cols: int = dataclasses.field(metadata={"static": True})

    @property
    def width(self) -> int:
        return self.colidxs.shape[1]

    @property
    def nnz(self) -> int:
        """Storage nnz (including padding slots)."""
        return self.colidxs.shape[0] * self.colidxs.shape[1]

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    # -- constructors --------------------------------------------------------

    @staticmethod
    def from_coo(coo, width: int = None) -> "ELLMatrix":
        """Host-side conversion from a COOMatrix (width defaults to the max
        row occupancy). Duplicated (row, col) entries are preserved as
        separate slots (they sum in products, same as COO)."""
        rows = np.asarray(coo.rows)
        cols = np.asarray(coo.cols)
        vals = np.asarray(coo.vals)
        counts = np.bincount(rows, minlength=coo.n_rows)
        w = int(counts.max(initial=0)) if width is None else width
        require(w >= int(counts.max(initial=0)),
                "width smaller than the densest row")
        w = max(w, 1)
        cidx = np.zeros((coo.n_rows, w), dtype=np.int32)
        cval = np.zeros((coo.n_rows, w), dtype=vals.dtype)
        order = np.argsort(rows, kind="stable")
        sr = rows[order]
        # slot of each entry within its row = rank - row start
        starts = np.searchsorted(sr, np.arange(coo.n_rows))
        slot = np.arange(len(sr)) - starts[sr]
        cidx[sr, slot] = cols[order]
        cval[sr, slot] = vals[order]
        return ELLMatrix(jnp.asarray(cidx), jnp.asarray(cval),
                         coo.n_rows, coo.n_cols)

    @staticmethod
    def from_dense(mat, abs_tol: float = 0.0) -> "ELLMatrix":
        from .coo import COOMatrix
        return ELLMatrix.from_coo(COOMatrix.from_dense(mat, abs_tol))

    # -- ops -----------------------------------------------------------------

    def to_dense(self) -> jax.Array:
        dense = jnp.zeros(self.shape, dtype=self.vals.dtype)
        rows = jnp.repeat(jnp.arange(self.n_rows, dtype=jnp.int32),
                          self.width)
        return dense.at[rows, self.colidxs.reshape(-1)].add(
            self.vals.reshape(-1))

    def blocked(self, kb: int = 128, bw_cap: int = None,
                word_major: int = 0):
        """One-time host-side conversion to BlockedELL (ops/ell_spmm.py).
        Concrete arrays required.
        bw_cap caps the per-(row, block) slot count, sending the excess
        through a COO overflow pass (two-tier form). word_major=4 builds
        the tables for word-major operand storage — the order an implicit
        ColMajor-natural DenseSkOp fills for free (ops/ell_spmm.py
        BlockedELL.word_major)."""
        from ..ops.ell_spmm import BlockedELL
        return BlockedELL.from_ell(self, kb=kb, bw_cap=bw_cap,
                                   word_major=word_major)

    def matmul(self, b: jax.Array, alpha=1.0) -> jax.Array:
        """self @ b via width gather passes: B[r] = sum_t vals[r,t] *
        b[colidxs[r,t]]. Pure gathers — no scatter/segment reductions."""
        b = jnp.asarray(b)
        require(b.ndim == 2 and b.shape[0] == self.n_cols,
                "operand height must equal n_cols")
        acc = jnp.zeros((self.n_rows, b.shape[1]), dtype=b.dtype)
        for t in range(self.width):
            acc = acc + self.vals[:, t].astype(b.dtype)[:, None] * \
                b[self.colidxs[:, t]]
        return jnp.asarray(alpha, b.dtype) * acc


def coo_to_ell(coo, width: int = None) -> ELLMatrix:
    return ELLMatrix.from_coo(coo, width)


def ell_to_coo(a: ELLMatrix):
    """Padding slots carry val == 0 and are preserved as explicit zeros
    (products are unaffected)."""
    from .base import NonzeroSort
    from .coo import COOMatrix
    rows = jnp.repeat(jnp.arange(a.n_rows, dtype=jnp.int32), a.width)
    return COOMatrix(rows, a.colidxs.reshape(-1), a.vals.reshape(-1),
                     a.n_rows, a.n_cols, NonzeroSort.CSR)
