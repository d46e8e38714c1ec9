"""Sparse data matrices (COO/CSR/CSC), conversions, and SpMM.

Counterpart of RandBLAS/sparse_data/ (see SURVEY.md §2 rows
14-19).
"""

from .base import IndexBase, NonzeroSort, nnz_in_dense
from .coo import COOMatrix
from .csr import CSRMatrix
from .csc import CSCMatrix
from .ell import ELLMatrix, coo_to_ell, ell_to_coo
from ..ops.ell_spmm import BlockedELL, blocked_ell_matmul
from .conversions import (
    coo_to_csr, csr_to_coo, coo_to_csc, csc_to_coo,
    transpose_as_csr, transpose_as_csc, to_coo,
)
from .spmm import left_spmm, right_spmm, spmm

__all__ = [
    "IndexBase", "NonzeroSort", "nnz_in_dense",
    "COOMatrix", "CSRMatrix", "CSCMatrix", "ELLMatrix",
    "coo_to_csr", "csr_to_coo", "coo_to_csc", "csc_to_coo",
    "coo_to_ell", "ell_to_coo", "BlockedELL", "blocked_ell_matmul",
    "transpose_as_csr", "transpose_as_csc", "to_coo",
    "left_spmm", "right_spmm", "spmm",
]
