"""Multi-chip sketching over jax.sharding meshes.

The reference's only parallelism is OpenMP threads with thread-count-
invariant streams (SURVEY.md §2.3). Counter addressing makes the
accelerator story strictly stronger: every device generates its tile of one global
operator directly from (seed, tile coordinates) — no communication for
generation, bit-identical to single-device execution — and only the GEMM
contraction reduces (a psum, NVLink all-reduce on a GPU host).
"""

from .distributed import (
    distributed_sketch, distributed_sketch_right, distributed_sketch_cols,
    distributed_sparse_sketch, distributed_sketch_sparse_data,
    make_sketch_mesh, distributed_sketch_jit,
)
from .multihost import (
    arrange_multihost_devices, initialize_multihost,
    make_multihost_sketch_mesh,
)

__all__ = ["distributed_sketch", "distributed_sketch_right",
           "distributed_sketch_cols", "distributed_sparse_sketch",
           "distributed_sketch_sparse_data", "make_sketch_mesh",
           "distributed_sketch_jit", "arrange_multihost_devices",
           "initialize_multihost", "make_multihost_sketch_mesh"]
