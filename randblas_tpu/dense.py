"""Dense sketching operators: distributions, operator objects, fill engine.

Counterpart of RandBLAS/dense_skops.hh. The crucial invariants
carried over from the reference:

1. *Counter addressing*: any submatrix of an implicit operator can be
   generated directly from (seed, offsets) — bit-identical to generating the
   full matrix and slicing (dense_skops.hh:97-170, tested
   test_denseskop.cc:171-296).
2. *next_state is a function of the distribution only*, computed by pure
   counter arithmetic, independent of how much of S was materialized
   (compute_next_state, dense_skops.hh:173-191). This enables seed-chained
   operator concatenation and streaming updates (rtd updates.rst).
3. *Fill order* (MajorAxis -> natural layout) decides which entries get
   which stream values, enabling seed-compatible growth of either dimension
   (dist_to_layout, dense_skops.hh:297-316).

Unlike the reference there is no buffer/ownership plumbing: operators are
lazy by default and materialize to ordinary (n_rows, n_cols) jnp arrays on
request; the fused Pallas sketch path never materializes them at all.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

import jax
import jax.numpy as jnp

from .base import Layout, MajorAxis, require
from .ops.dense_fill import fill_colmajor, fill_rowmajor, fill_next_state
from .rng.state import RNGState


class DenseDistName(enum.Enum):
    """Scalar distribution families (dense_skops.hh:204-218)."""
    Gaussian = "G"   # mean 0, variance 1
    Uniform = "U"    # uniform on [-sqrt(3), sqrt(3)] (variance 1)
    BlackBox = "B"   # user-provided buffer


_TRANSFORM = {DenseDistName.Gaussian: "boxmul",
              DenseDistName.Uniform: "uneg11"}

# x64 (f64-stream) fill engine policy: "auto" uses the native OpenMP C++
# engine when built (bitwise-identical to rng/x64.py for Uniform, <= 1
# ulp for Gaussian — PARITY.md "known divergences"); False forces the
# single-threaded vectorized-numpy path (bit-stable vs the KAT replay).
use_native_x64 = "auto"


@dataclasses.dataclass(frozen=True)
class DenseDist:
    """A distribution over dense sketching operators (dense_skops.hh:222-294)."""
    n_rows: int
    n_cols: int
    family: DenseDistName = DenseDistName.Gaussian
    major_axis: MajorAxis = None  # type: ignore[assignment]

    def __post_init__(self):
        require(self.n_rows > 0 and self.n_cols > 0,
                "DenseDist dimensions must be positive")
        if self.major_axis is None:
            ma = (MajorAxis.Undefined
                  if self.family == DenseDistName.BlackBox
                  else MajorAxis.Long)
            object.__setattr__(self, "major_axis", ma)
        if self.family == DenseDistName.BlackBox:
            require(self.major_axis == MajorAxis.Undefined,
                    "BlackBox requires MajorAxis.Undefined")
        else:
            require(self.major_axis != MajorAxis.Undefined,
                    "random families require a defined MajorAxis")


def dist_to_layout(d: DenseDist) -> Layout:
    """Natural fill order of the distribution (dense_skops.hh:297-310)."""
    require(d.major_axis != MajorAxis.Undefined,
            "dist_to_layout needs a defined major axis")
    is_wide = d.n_rows < d.n_cols
    fa_long = d.major_axis == MajorAxis.Long
    if is_wide and fa_long:
        return Layout.RowMajor
    if is_wide:
        return Layout.ColMajor
    if fa_long:
        return Layout.ColMajor
    return Layout.RowMajor


def major_axis_length(d: DenseDist) -> int:
    require(d.major_axis != MajorAxis.Undefined,
            "major_axis_length needs a defined major axis")
    return (max(d.n_rows, d.n_cols) if d.major_axis == MajorAxis.Long
            else min(d.n_rows, d.n_cols))


def isometry_scale_factor(d) -> float:
    """Scale making E[ (c S)^T (c S) ] = I (dense_skops.hh:318-326 for
    DenseDist; sparse_skops.hh:167-177 for SparseDist)."""
    from .sparse import SparseDist  # local import to avoid a cycle
    from .trig import TrigDist, trig_isometry_scale
    if isinstance(d, TrigDist):
        return trig_isometry_scale(d)
    if isinstance(d, SparseDist):
        if d.major_axis == MajorAxis.Short:
            return d.vec_nnz ** -0.5
        minor = min(d.n_rows, d.n_cols)
        major = max(d.n_rows, d.n_cols)
        return math.sqrt(major / (d.vec_nnz * minor))
    require(d.family != DenseDistName.BlackBox,
            "no isometry scale for BlackBox")
    return min(d.n_rows, d.n_cols) ** -0.5


def compute_next_state(dist: DenseDist, state: RNGState) -> RNGState:
    """Advance past a full sample of `dist` by counter arithmetic alone
    (dense_skops.hh:173-191). ``block_width`` is the counter width in
    WORDS (= values per block), so x32 and x64 states share the exact
    same arithmetic — the reference's ctr_size is CTR::static_size for
    either counter element width."""
    if dist.major_axis == MajorAxis.Undefined:
        return state
    ctr_size = state.block_width
    major_len = major_axis_length(dist)
    minor_len = dist.n_rows + (dist.n_cols - major_len)
    pad = (-major_len) % ctr_size
    ctr_major_axis_stride = (major_len + pad) // ctr_size
    return state.incr(ctr_major_axis_stride * minor_len)


def fill_dense_submat(
    dist: DenseDist,
    state: RNGState,
    n_rows: int,
    n_cols: int,
    ro_s: int = 0,
    co_s: int = 0,
    dtype=jnp.float32,
) -> jax.Array:
    """The (ro_s:ro_s+n_rows, co_s:co_s+n_cols) block of the implicit sample
    of `dist` seeded at `state`, as an (n_rows, n_cols) array.

    Counterpart of fill_dense(layout, D, ...) (dense_skops.hh:487-532) —
    minus the layout argument: JAX arrays carry their own (row-major)
    storage, so the requested-layout flip is irrelevant here; fill order
    (which affects *values*) is honored via dist_to_layout.
    """
    require(dist.family != DenseDistName.BlackBox,
            "fill_dense cannot be called with the BlackBox family")
    require(dist.n_rows >= n_rows + ro_s, "row range out of bounds")
    require(dist.n_cols >= n_cols + co_s, "column range out of bounds")
    natural = dist_to_layout(dist)
    ma_len = major_axis_length(dist)
    transform = _TRANSFORM[dist.family]
    if state.is_x64:
        return _fill_submat_x64(dist, state, n_rows, n_cols, ro_s, co_s,
                                dtype, natural, ma_len, transform)
    if natural == Layout.ColMajor:
        # generate the transpose in row-major order (dense_skops.hh:494-498);
        # fill_colmajor computes that transpose natively in word planes
        # (same values, no transpose pass — ops/dense_fill.py)
        ptr = ro_s + co_s * ma_len
        vals = fill_colmajor(ma_len, n_cols, n_rows, ptr, state, transform)
    else:
        ptr = ro_s * ma_len + co_s
        vals = fill_rowmajor(ma_len, n_rows, n_cols, ptr, state, transform)
    vals = vals.astype(dtype)
    if dist.family == DenseDistName.Uniform:
        vals = vals * jnp.asarray(math.sqrt(3.0), dtype=dtype)
    return vals


def _fill_submat_x64(dist, state, n_rows, n_cols, ro_s, co_s, dtype,
                     natural, ma_len, transform) -> jax.Array:
    """Native-f64 submatrix fill for x64-counter states (host-side).

    The reference's fill engine templated on a 64-bit-counter CBRNG
    produces native double streams (random_gen.hh:121-173,
    dense_skops.hh:97-170); this is its parity path. Generation happens
    on the HOST (the OpenMP C++ engine when built and ``use_native_x64``
    allows, else vectorized numpy): the 64-bit-counter generators need
    64-bit integer arithmetic, and the reference's fill is host code
    too. The ColMajor-natural
    case fills the transposed parent row-major and flips, exactly the
    reference's omatcopy fallback (dense_skops.hh:523-530).
    """
    import numpy as np
    from .rng import x64 as rng64
    if isinstance(state.counter, jax.core.Tracer):
        raise ValueError(
            "x64 (f64-stream) operators generate on the host and cannot "
            "be filled under jit with a traced seed state; materialize "
            "outside the traced region and pass the array in")

    def rowmajor64(ncp, nr, nc, ptr):
        from . import native as native_mod
        if use_native_x64 is not False and native_mod.available():
            return native_mod.fill_rowmajor64(
                ncp, nr, nc, ptr,
                rng64.limbs_to_words(np.asarray(state.counter)),
                rng64.limbs_to_words(np.asarray(state.key)),
                transform == "boxmul", state.rng)
        return rng64.fill_rowmajor64(ncp, nr, nc, ptr, state, transform)

    if natural == Layout.ColMajor:
        ptr = ro_s + co_s * ma_len
        vals = rowmajor64(ma_len, n_cols, n_rows, ptr).T
    else:
        ptr = ro_s * ma_len + co_s
        vals = rowmajor64(ma_len, n_rows, n_cols, ptr)
    if dist.family == DenseDistName.Uniform:
        vals = vals * np.float64(math.sqrt(3.0))
    if (jnp.dtype(dtype) == jnp.float64
            and not jax.config.jax_enable_x64):
        raise ValueError(
            "materializing an f64 operator requires jax_enable_x64 "
            "(the values would be silently downcast to f32)")
    return jnp.asarray(np.ascontiguousarray(vals)).astype(dtype)


def fill_dense_submat_traced(
    dist: DenseDist,
    state: RNGState,
    n_rows: int,
    n_cols: int,
    ro_s,
    co_s,
    dtype=jnp.float32,
) -> jax.Array:
    """fill_dense_submat with *traced* offsets (SPMD shards).

    Same values as fill_dense_submat at the same offsets. Alignment
    contract (uncheckable on traced values): the offset along the
    distribution's major axis must be a multiple of the RNG counter width
    (4 for Philox4x32) — natural-minor-axis offsets are unconstrained.
    Used by randblas_tpu.parallel to generate per-device tiles of one
    global operator with zero communication.
    """
    from .ops.dense_fill import (fill_colmajor_traced_offset,
                                 fill_rowmajor_traced_offset)
    require(dist.family != DenseDistName.BlackBox,
            "fill_dense cannot be called with the BlackBox family")
    natural = dist_to_layout(dist)
    ma_len = major_axis_length(dist)
    transform = _TRANSFORM[dist.family]
    if natural == Layout.ColMajor:
        vals = fill_colmajor_traced_offset(
            ma_len, n_cols, n_rows, co_s, ro_s, state, transform)
    else:
        vals = fill_rowmajor_traced_offset(
            ma_len, n_rows, n_cols, ro_s, co_s, state, transform)
    vals = vals.astype(dtype)
    if dist.family == DenseDistName.Uniform:
        vals = vals * jnp.asarray(math.sqrt(3.0), dtype=dtype)
    return vals


def skop_word_major_rows(S, w: int):
    """The FULL operator S as a word-major row-storage array, or None.

    Storage row s = (k % w)*ceil(n_rows/w) + k//w holds operator row k —
    exactly the order a ColMajor-natural plane fill produces with zero
    interleave (ops/dense_fill.py::fill_colmajor_planes), and the order
    word-major BlockedELL tables expect (ops/ell_spmm.py). Returns a
    float32 (w*ceil(n_rows/w), n_cols) array whose phantom rows (storage
    rows whose k >= n_rows, when n_rows % w != 0) are ZEROED — a
    word-major consumer whose n_cols exceeds this operator's height
    within the same w-block would otherwise multiply real data by the
    generated later-counter values (the padding invariant: phantom
    rows/columns may only ever multiply zero data). None when the
    operator is materialized, not ColMajor-natural, or its generator has
    no w-word plane form.
    """
    from .ops.dense_fill import fill_colmajor_planes
    if getattr(S, "materialized", None) is not None:
        return None
    if S.dist.family not in (DenseDistName.Gaussian, DenseDistName.Uniform):
        return None
    if dist_to_layout(S.dist) != Layout.ColMajor:
        return None
    state = S.seed_state
    if state.len_c != w:
        return None
    ma_len = major_axis_length(S.dist)
    planes = fill_colmajor_planes(ma_len, S.n_cols, S.n_rows, 0, state,
                                  _TRANSFORM[S.dist.family])
    if planes is None:
        return None
    gs, fbs, rows_gen, nblk = planes
    assert fbs == 0
    if S.dist.family == DenseDistName.Uniform:
        scale = jnp.float32(math.sqrt(3.0))
        gs = tuple(g * scale for g in gs)
    out = jnp.concatenate([g.T for g in gs], axis=0)
    if S.n_rows % w:
        # zero the phantom rows: storage row s holds k = (s % nblk)*w
        # + s//nblk; rows with k >= n_rows are padding and must be 0
        nblk = out.shape[0] // w
        s_idx = jnp.arange(out.shape[0])
        k_of_s = (s_idx % nblk) * w + s_idx // nblk
        out = jnp.where((k_of_s < S.n_rows)[:, None], out, 0.0)
    return out[:, :S.n_cols]


def fill_dense(dist: DenseDist, state: RNGState, dtype=jnp.float32):
    """Full sample of `dist`: returns (array, next_state) where next_state
    reflects the counters actually consumed (dense_skops.hh:565-568)."""
    arr = fill_dense_submat(dist, state, dist.n_rows, dist.n_cols, 0, 0,
                            dtype)
    natural = dist_to_layout(dist)
    ma_len = major_axis_length(dist)
    n_rows_ = dist.n_cols if natural == Layout.ColMajor else dist.n_rows
    n_cols_ = dist.n_rows if natural == Layout.ColMajor else dist.n_cols
    nxt = fill_next_state(ma_len, n_rows_, n_cols_, 0, state)
    return arr, nxt


@jax.tree_util.register_pytree_node_class
class DenseSkOp:
    """A sample from a DenseDist (dense_skops.hh:333-419), lazy by default.

    Pytree: (seed_state, next_state, materialized-or-None) are children;
    the distribution and dtype are static. This lets whole operators cross
    jit / shard_map boundaries.
    """

    def __init__(
        self,
        dist: DenseDist,
        seed_state: RNGState,
        *,
        next_state: Optional[RNGState] = None,
        materialized: Optional[jax.Array] = None,
        dtype=None,
    ):
        if isinstance(seed_state, int):
            seed_state = RNGState.from_key(seed_state)
        self.dist = dist
        self.seed_state = seed_state
        self.next_state = (next_state if next_state is not None
                           else compute_next_state(dist, seed_state))
        if dtype is None:
            # width deduction, random_gen.hh:121-173: 64-bit-counter
            # CBRNGs generate native double streams
            dtype = (jnp.float64 if getattr(seed_state, "is_x64", False)
                     else jnp.float32)
        self.dtype = jnp.dtype(dtype)
        if dist.family == DenseDistName.BlackBox:
            require(materialized is not None,
                    "BlackBox operators need an explicit array")
        if materialized is not None:
            materialized = jnp.asarray(materialized, dtype=dtype)
            require(materialized.shape == (dist.n_rows, dist.n_cols),
                    "materialized array must match the distribution shape")
        self.materialized = materialized

    # -- convenience --------------------------------------------------------

    @property
    def n_rows(self) -> int:
        return self.dist.n_rows

    @property
    def n_cols(self) -> int:
        return self.dist.n_cols

    @property
    def shape(self):
        return (self.dist.n_rows, self.dist.n_cols)

    def materialize(self) -> jax.Array:
        """Dense (n_rows, n_cols) array of this operator. Counterpart of
        fill_dense(S) (dense_skops.hh:583-592), but functional: the array is
        returned (and cached on the object) instead of mutating a buffer.

        The cache is skipped while tracing: if this operator is closed over
        by a jitted function, caching would store a tracer on the live
        object and poison later uses outside the trace."""
        if self.materialized is None:
            arr = fill_dense_submat(self.dist, self.seed_state,
                                    self.n_rows, self.n_cols, 0, 0,
                                    self.dtype)
            if not isinstance(arr, jax.core.Tracer):
                self.materialized = arr
            return arr
        return self.materialized

    def submat(self, n_rows: int, n_cols: int, ro_s: int, co_s: int,
               dtype=None) -> jax.Array:
        """Materialize just a block (submatrix_as_blackbox,
        dense_skops.hh:595-602) — same values as slicing materialize().

        `dtype` overrides the returned dtype (default: the operator's).
        The result is always bit-identical to materialize() filled at
        the OPERATOR's dtype and cast. For Gaussian that lets a narrower
        request fill directly at the target dtype (values are
        f32-internal, rng/transforms.py — callers like the hiprec GEMM
        route skip materializing the wide buffer entirely); Uniform
        applies its sqrt(3) scale in the fill dtype, so a narrowing
        request fills at the operator dtype first and casts — a direct
        narrow fill would double-round the scale ~1 ulp apart from the
        materialized branch."""
        dtype = self.dtype if dtype is None else dtype
        require(0 <= ro_s and self.n_rows >= n_rows + ro_s,
                "row range out of bounds")
        require(0 <= co_s and self.n_cols >= n_cols + co_s,
                "column range out of bounds")
        if self.materialized is not None:
            return jax.lax.slice(self.materialized, (ro_s, co_s),
                                 (ro_s + n_rows, co_s + n_cols)
                                 ).astype(dtype)
        fill_dtype = dtype
        if (dtype != self.dtype
                and self.dist.family == DenseDistName.Uniform):
            fill_dtype = self.dtype
        vals = fill_dense_submat(self.dist, self.seed_state, n_rows,
                                 n_cols, ro_s, co_s, fill_dtype)
        return vals.astype(dtype)

    # -- pytree protocol -----------------------------------------------------

    def tree_flatten(self):
        children = (self.seed_state, self.next_state, self.materialized)
        aux = (self.dist, self.dtype)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        dist, dtype = aux
        seed_state, next_state, materialized = children
        obj = object.__new__(cls)
        obj.dist = dist
        obj.seed_state = seed_state
        obj.next_state = next_state
        obj.dtype = dtype
        obj.materialized = materialized
        return obj

    def __repr__(self):
        return (f"DenseSkOp({self.dist.n_rows}x{self.dist.n_cols}, "
                f"{self.dist.family.name}, major={self.dist.major_axis.name},"
                f" dtype={self.dtype}, "
                f"{'materialized' if self.materialized is not None else 'lazy'})")


def gaussian_operator(n_rows: int, n_cols: int, key: int = 0,
                      dtype=jnp.float32) -> DenseSkOp:
    """Convenience: standard Gaussian operator from an integer key."""
    return DenseSkOp(DenseDist(n_rows, n_cols), RNGState.from_key(key),
                     dtype=dtype)
