"""randblas_tpu: a JAX sketching framework for randomized NLA.

A ground-up JAX/Pallas rebuild of the capabilities of RandBLAS (the
BALLISTIC project's C++ sketching library): BLAS-like sketching of dense
and sparse data with dense (Gaussian/uniform) and sparse-sign operators
whose entries are defined implicitly by counter-based RNGs, so operators
can be regenerated anywhere — any submatrix, any device, any mesh shape —
bit-identically and without communication.

Compute path: jit/XLA + a Pallas (Triton) kernel on the GPU. Parallel
path: jax.sharding meshes (the counter-addressable fill makes multi-chip
generation embarrassingly parallel; only contractions reduce).
"""

__version__ = "0.1.0"

from .rng import RNGState, default_state
from .base import MajorAxis, Layout, Op, Side
from .dense import (
    DenseDistName, DenseDist, DenseSkOp, fill_dense, fill_dense_submat,
    isometry_scale_factor,
)
from .sparse import (
    SparseDist, SparseSkOp, fill_sparse, print_sparse,
    repeated_fisher_yates,
)
from .trig import TrigDist, TrigSkOp, srht_operator
from .tensor import (kfjlt_sketch, kfjlt_sketch_explicit,
                     polynomial_kernel_features, tensor_sketch,
                     tensor_sketch_explicit, tensor_sketch_vectors)
from .ops.hadamard import hadamard_matrix, hadamard_transform
from .skge import sketch_general, sketch
from .skve import sketch_vector
from .sksy import sketch_symmetric, require_symmetric
from .sksp import sketch_sparse
from .sparse_data import (
    COOMatrix, CSRMatrix, CSCMatrix, IndexBase, NonzeroSort,
    left_spmm, right_spmm, spmm,
)
from .flags import flags, get_flag, set_flag
from .util import (
    weights_to_cdf, sample_indices_iid, sample_indices_iid_uniform,
    symmetrize, overwrite_triangle, transpose_square, safe_scal,
    print_colmaj,
)

__all__ = [
    "RNGState", "default_state",
    "MajorAxis", "Layout", "Op", "Side",
    "DenseDistName", "DenseDist", "DenseSkOp",
    "fill_dense", "fill_dense_submat", "isometry_scale_factor",
    "SparseDist", "SparseSkOp", "fill_sparse", "repeated_fisher_yates",
    "TrigDist", "TrigSkOp", "srht_operator",
    "kfjlt_sketch", "kfjlt_sketch_explicit",
    "polynomial_kernel_features", "tensor_sketch",
    "tensor_sketch_explicit", "tensor_sketch_vectors",
    "hadamard_matrix", "hadamard_transform",
    "sketch_general", "sketch", "sketch_vector", "sketch_symmetric",
    "require_symmetric", "sketch_sparse",
    "COOMatrix", "CSRMatrix", "CSCMatrix", "IndexBase", "NonzeroSort",
    "left_spmm", "right_spmm", "spmm",
    "weights_to_cdf", "sample_indices_iid", "sample_indices_iid_uniform",
    "symmetrize", "overwrite_triangle", "transpose_square",
    "safe_scal", "print_colmaj", "print_sparse",
    "flags", "get_flag", "set_flag",
]
