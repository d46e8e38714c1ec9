"""Sparse-matrix containers: shared helpers.

Counterpart of RandBLAS/sparse_data/base.hh. Containers are
frozen pytrees over jnp index/value arrays with static shape metadata, so
they pass through jit/shard_map. nnz is static (a python int), which is
what XLA needs anyway.

Index base: the reference tracks Zero/One index bases (base.hh:39-46);
containers here are always zero-based internally, with reindexing applied
at construction for one-based input (conversions.py).
"""

from __future__ import annotations

import enum

import jax.numpy as jnp
import numpy as np


class IndexBase(enum.Enum):
    Zero = "Z"
    One = "O"


class NonzeroSort(enum.Enum):
    """Sort-order tracking for COO triplets (coo_matrix.hh:52-101)."""
    CSC = "CSC"   # sorted by (col, row)
    CSR = "CSR"   # sorted by (row, col)
    NONE = "None"


def detect_coo_sort(rows, cols) -> NonzeroSort:
    """Host-side sort detection on concrete index arrays
    (coo_matrix.hh:77-101)."""
    r = np.asarray(rows)
    c = np.asarray(cols)
    if len(r) == 0:
        return NonzeroSort.CSR
    csr_key = r.astype(np.int64) * (int(c.max(initial=0)) + 1) + c
    if (np.diff(csr_key) >= 0).all():
        return NonzeroSort.CSR
    csc_key = c.astype(np.int64) * (int(r.max(initial=0)) + 1) + r
    if (np.diff(csc_key) >= 0).all():
        return NonzeroSort.CSC
    return NonzeroSort.NONE


def ptr_to_indices(ptr, nnz: int):
    """Expand a compressed pointer array to per-nonzero indices, inside jit.

    ptr: int[n+1] monotone; returns int32[nnz] with value i for entries in
    [ptr[i], ptr[i+1]). Inverse of sorted_nonzero_locations_to_pointer_array
    (sparse_data/base.hh:68-91).
    """
    ptr = jnp.asarray(ptr)
    positions = jnp.arange(nnz, dtype=ptr.dtype)
    return (jnp.searchsorted(ptr, positions, side="right") - 1).astype(
        jnp.int32)


def indices_to_ptr(idxs, dim: int, nnz: int):
    """Compressed pointer array from *sorted* per-nonzero indices, inside
    jit: ptr[i] = #entries with index < i."""
    idxs = jnp.asarray(idxs)
    boundaries = jnp.arange(dim + 1, dtype=jnp.int32)
    return jnp.searchsorted(idxs.astype(jnp.int32), boundaries,
                            side="left").astype(jnp.int32)


def nnz_in_dense(mat, abs_tol: float = 0.0) -> int:
    """Host-side count of entries with |x| > abs_tol
    (sparse_data/base.hh:48-66)."""
    return int((np.abs(np.asarray(mat)) > abs_tol).sum())
