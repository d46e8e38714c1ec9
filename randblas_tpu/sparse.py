"""Sparse-sign sketching operators (SASO/LASO).

Counterpart of RandBLAS/sparse_skops.hh. A SparseSkOp samples,
per major-axis vector, ``vec_nnz`` indices *without replacement* via
repeated Fisher-Yates, with ±1 values — reproducing the reference's exact
counter consumption (one CBRNG block per FY step, vector i starting at
counter offset i*vec_nnz; sparse_skops.hh:54-106).

Vectorization strategy: the reference keeps a dim_major-length work vector
and restores it after each vector (the "restore trick" that makes
submatrices reproducible). Because every vector starts from the identity
permutation and touches at most 2*vec_nnz positions, we never build that
work vector: reads are resolved against a short chronological write log
(O(vec_nnz^2) compares per vector — vec_nnz is ~8). That turns the sampler
into a `vmap` over the minor axis with a tiny unrolled inner loop, instead
of a sequential CPU loop over (dim_minor x vec_nnz) with a dim_major-sized
state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from .base import MajorAxis, require
from .rng.bits import mul64_u32, ctr_add64
from .rng.state import RNGState


@dataclasses.dataclass(frozen=True)
class SparseDist:
    """Distribution over sparse-sign operators (sparse_skops.hh:100-165).

    major_axis == Short (SASO): exactly vec_nnz nonzeros per short-axis
    vector. major_axis == Long (LASO): at most vec_nnz per long-axis vector.
    """
    n_rows: int
    n_cols: int
    vec_nnz: int
    major_axis: MajorAxis = MajorAxis.Short

    def __post_init__(self):
        require(self.n_rows > 0 and self.n_cols > 0,
                "SparseDist dimensions must be positive")
        require(self.vec_nnz > 0, "vec_nnz must be positive")
        require(self.major_axis in (MajorAxis.Short, MajorAxis.Long),
                "SparseDist major_axis must be Short or Long")
        dim_major = (min(self.n_rows, self.n_cols)
                     if self.major_axis == MajorAxis.Short
                     else max(self.n_rows, self.n_cols))
        # Fisher-Yates samples vec_nnz indices per minor-axis vector
        # WITHOUT replacement from dim_major positions
        # (sparse_skops.hh:65 raises inside the sampler; we raise at
        # construction, the earliest trace-time point).
        require(self.vec_nnz <= dim_major,
                f"vec_nnz = {self.vec_nnz} exceeds the major-axis length "
                f"{dim_major}: cannot sample that many indices without "
                "replacement")


def sparse_nnz(dist: SparseDist) -> int:
    """Total stored nonzeros (sparse_skops.hh nnz helper :454-473)."""
    if dist.major_axis == MajorAxis.Short:
        return dist.vec_nnz * max(dist.n_rows, dist.n_cols)
    return dist.vec_nnz * min(dist.n_rows, dist.n_cols)


def compute_next_state(dist: SparseDist, state: RNGState) -> RNGState:
    """Replicates sparse::compute_next_state (sparse_skops.hh:116-126)
    exactly — including its choice of min() for Short-major operators, which
    is part of the reference's pinned stream contract."""
    if dist.major_axis == MajorAxis.Short:
        minor_len = min(dist.n_rows, dist.n_cols)
    else:
        minor_len = max(dist.n_rows, dist.n_cols)
    return state.incr(minor_len * dist.vec_nnz)


def repeated_fisher_yates(
    state: RNGState,
    vec_nnz: int,
    dim_major: int,
    dim_minor: int,
    dtype=jnp.float32,
    index_dtype=jnp.int32,
):
    """Sample `dim_minor` independent draws of `vec_nnz` indices from
    {0..dim_major-1} without replacement, plus ±1 values.

    Returns (idxs_major[dim_minor, vec_nnz], vals[dim_minor, vec_nnz]).
    Bit-compatible with sparse::repeated_fisher_yates
    (sparse_skops.hh:54-106): index = pre-swap work-vector value at
    ell = j + rv[0] % (dim_major - j); value sign from rv[1] % 2; one
    counter block per step; vector i starts at counter offset i*vec_nnz.
    Like the reference, the returned stream is submatrix-reproducible: the
    first `r` vectors of a (vec_nnz, dim_major, dim_minor) draw equal a
    (vec_nnz, dim_major, r) draw.
    """
    require(vec_nnz <= dim_major,
            "vec_nnz must be at most the major-axis length")
    require(dim_major < 2 ** 31, "dim_major must fit in int32")
    generate = state.generate
    key = state.key
    base_counter = state.counter
    k = int(vec_nnz)

    def one_vector(vec_idx):
        # counter base for this minor-axis vector: state + vec_idx * vec_nnz
        off_lo, off_hi = mul64_u32(vec_idx.astype(jnp.uint32),
                                   jnp.uint32(k))
        ctr0 = ctr_add64(base_counter, off_lo, off_hi)

        # chronological write log of the virtual work vector (identity at
        # start): positions / values; 2 writes per FY step.
        log_pos = jnp.full((2 * k,), -1, dtype=jnp.int32)
        log_val = jnp.zeros((2 * k,), dtype=jnp.int32)
        idxs = jnp.zeros((k,), dtype=jnp.int32)
        vals = jnp.zeros((k,), dtype=dtype)

        def read(p, log_pos, log_val):
            # latest write to position p wins; unwritten -> identity (p).
            v = p
            for t in range(2 * k):
                v = jnp.where(log_pos[t] == p, log_val[t], v)
            return v

        for j in range(k):
            rv = generate(ctr_add64(ctr0, jnp.uint32(j), jnp.uint32(0)), key)
            ell = (jnp.int32(j)
                   + (rv[0] % jnp.uint32(dim_major - j)).astype(jnp.int32))
            at_ell = read(ell, log_pos, log_val)
            at_j = read(jnp.int32(j), log_pos, log_val)
            idxs = idxs.at[j].set(at_ell)
            one = jnp.asarray(1.0, dtype)
            vals = vals.at[j].set(jnp.where(rv[1] % 2 == 0, one, -one))
            log_pos = log_pos.at[2 * j].set(ell)
            log_val = log_val.at[2 * j].set(at_j)
            log_pos = log_pos.at[2 * j + 1].set(jnp.int32(j))
            log_val = log_val.at[2 * j + 1].set(at_ell)
        return idxs, vals

    vec_ids = jnp.arange(dim_minor, dtype=jnp.uint32)
    idxs, vals = jax.vmap(one_vector)(vec_ids)
    return idxs.astype(index_dtype), vals


@jax.tree_util.register_pytree_node_class
class SparseSkOp:
    """A sample from a SparseDist (sparse_skops.hh:184-377), stored as COO
    triplets in flattened (minor-vector-major) order like the reference.

    Pytree: states + COO arrays are children; dist/dtypes are static.
    """

    def __init__(
        self,
        dist: SparseDist,
        seed_state: RNGState,
        *,
        rows: Optional[jax.Array] = None,
        cols: Optional[jax.Array] = None,
        vals: Optional[jax.Array] = None,
        next_state: Optional[RNGState] = None,
        dtype=jnp.float32,
        index_dtype=jnp.int32,
        canonical: bool = False,
    ):
        if isinstance(seed_state, int):
            seed_state = RNGState.from_key(seed_state)
        self.dist = dist
        self.seed_state = seed_state
        self.next_state = (next_state if next_state is not None
                           else compute_next_state(dist, seed_state))
        self.dtype = jnp.dtype(dtype)
        self.index_dtype = jnp.dtype(index_dtype)
        provided = [x is not None for x in (rows, cols, vals)]
        require(all(provided) or not any(provided),
                "rows/cols/vals must be given together")
        self.rows = rows
        self.cols = cols
        self.vals = vals
        # canonical: triplets are in the internal fill's minor-vector-major
        # order (vec_nnz consecutive entries per minor-axis vector). Set by
        # filled(); the fixed-nnz/one-hot/row-gather fast paths in skge are
        # only valid for canonical triplets — user-supplied COO data in any
        # other order takes the general COO path (matching the reference's
        # left_spmm, which handles arbitrary order).
        self.canonical = bool(canonical) and self.known_filled

    @property
    def known_filled(self) -> bool:
        return self.rows is not None

    @property
    def n_rows(self) -> int:
        return self.dist.n_rows

    @property
    def n_cols(self) -> int:
        return self.dist.n_cols

    @property
    def shape(self):
        return (self.dist.n_rows, self.dist.n_cols)

    @property
    def nnz(self) -> int:
        return sparse_nnz(self.dist)

    def filled(self) -> "SparseSkOp":
        """Functional fill: returns an operator with COO data attached
        (fill_sparse, sparse_skops.hh:390-413)."""
        if self.known_filled:
            return self
        d = self.dist
        long_len = max(d.n_rows, d.n_cols)
        short_len = min(d.n_rows, d.n_cols)
        is_wide = d.n_rows == short_len
        if d.major_axis == MajorAxis.Short:
            dim_major, dim_minor = short_len, long_len
        else:
            dim_major, dim_minor = long_len, short_len
        idxs_major, vals = repeated_fisher_yates(
            self.seed_state, d.vec_nnz, dim_major, dim_minor,
            dtype=self.dtype, index_dtype=self.index_dtype)
        idxs_major = idxs_major.reshape(-1)
        vals = vals.reshape(-1)
        idxs_minor = jnp.repeat(
            jnp.arange(dim_minor, dtype=self.index_dtype), d.vec_nnz)
        # map (major, minor) index roles onto (rows, cols): the major axis of
        # sampling is the short axis for SASO, long axis for LASO
        # (fill_sparse, sparse_skops.hh:390-413).
        short_is_major = d.major_axis == MajorAxis.Short
        if is_wide == short_is_major:
            rows, cols = idxs_major, idxs_minor
        else:
            rows, cols = idxs_minor, idxs_major
        return SparseSkOp(d, self.seed_state, rows=rows, cols=cols,
                          vals=vals, next_state=self.next_state,
                          dtype=self.dtype, index_dtype=self.index_dtype,
                          canonical=True)

    def materialize(self) -> jax.Array:
        """Densify (for oracles/tests; never used on the fast path)."""
        s = self.filled()
        dense = jnp.zeros(self.shape, dtype=self.dtype)
        return dense.at[s.rows, s.cols].add(s.vals)

    def transpose(self) -> "SparseSkOp":
        """Zero-copy transpose view (sparse_skops.hh transpose :496-513)."""
        s = self.filled()
        dist_t = SparseDist(self.dist.n_cols, self.dist.n_rows,
                            self.dist.vec_nnz, self.dist.major_axis)
        # transposing swaps index roles but keeps the minor-vector grouping,
        # so canonical order is preserved.
        return SparseSkOp(dist_t, s.seed_state, rows=s.cols, cols=s.rows,
                          vals=s.vals, next_state=s.next_state,
                          dtype=s.dtype, index_dtype=s.index_dtype,
                          canonical=s.canonical)

    # -- pytree protocol -----------------------------------------------------

    def tree_flatten(self):
        children = (self.seed_state, self.next_state, self.rows, self.cols,
                    self.vals)
        aux = (self.dist, self.dtype, self.index_dtype, self.canonical)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        dist, dtype, index_dtype, canonical = aux
        seed_state, next_state, rows, cols, vals = children
        obj = object.__new__(cls)
        obj.dist = dist
        obj.seed_state = seed_state
        obj.next_state = next_state
        obj.dtype = dtype
        obj.index_dtype = index_dtype
        obj.rows = rows
        obj.cols = cols
        obj.vals = vals
        obj.canonical = canonical
        return obj

    def __repr__(self):
        kind = "SASO" if self.dist.major_axis == MajorAxis.Short else "LASO"
        return (f"SparseSkOp({self.dist.n_rows}x{self.dist.n_cols}, {kind}, "
                f"vec_nnz={self.dist.vec_nnz}, "
                f"{'filled' if self.known_filled else 'lazy'})")


def fill_sparse(S: SparseSkOp) -> SparseSkOp:
    """Functional counterpart of fill_sparse(S) (sparse_skops.hh:390-413)."""
    return S.filled()


def print_sparse(S: SparseSkOp, file=None) -> None:
    """Debug printer for sparse sketching operators, mirroring
    print_sparse (sparse_skops.hh:416-443): operator kind (SASO/LASO),
    dimensions, then the row-index / column-index / value triplet vectors.
    """
    import sys
    out = sys.stdout if file is None else file
    s = S.filled()
    kind = ("SASO: short-axis-sparse operator"
            if S.dist.major_axis == MajorAxis.Short
            else "LASO: long-axis-sparse operator")
    print("SparseSkOp information", file=out)
    print(f"\t{kind}", file=out)
    print(f"\tn_rows = {S.dist.n_rows}", file=out)
    print(f"\tn_cols = {S.dist.n_cols}", file=out)
    import numpy as np
    for label, arr in (("row indices", s.rows), ("column indices", s.cols),
                       ("values", s.vals)):
        body = ", ".join(str(v) for v in np.asarray(arr).tolist())
        print(f"\tvector of {label}\n\t\t{body}", file=out)
