"""Distributed sketching: shard_map SPMD over a device mesh.

Sharding layout for B = S @ A (left sketch):

    mesh axes: ('model', 'data')            # either may be size 1
    A: P('data', None)        -- m (long) axis sharded over 'data'
    S: implicit               -- tile (ro, co) = f(axis_index) per device
    B: P('model', None)       -- d axis sharded over 'model'; contraction
                                 over m psum-reduced across 'data'

Each device fills exactly the (d/model x m/data) tile of the global
operator its coordinates dictate, via counter-addressed traced-offset fill
(dense.fill_dense_submat_traced) — zero communication for generation. The
only collective is the psum of partial products over 'data' (an
all-reduce), exactly where a sharded GEMM must reduce.

Determinism across mesh shapes (tests/test_distributed.py): operator
*generation* is bitwise invariant to the mesh (tile values depend only on
seed + global coordinates); the contraction's psum reassociates the f32
sum across 'data' shards, so full sketches agree to reduction-order
tolerance, like any sharded GEMM.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import backend
from ..base import require
from ..dense import DenseSkOp, fill_dense_submat_traced
from ..sparse import SparseSkOp
from ..trig import TrigSkOp
from ..ops.coo_apply import coo_left_apply


def make_sketch_mesh(model: int = 1, data: Optional[int] = None,
                     devices=None) -> Mesh:
    """A ('model', 'data') mesh over the available devices."""
    devices = jax.devices() if devices is None else devices
    if data is None:
        data = len(devices) // model
    require(model * data == len(devices),
            f"mesh {model}x{data} != {len(devices)} devices")
    arr = np.array(devices).reshape(model, data)
    return Mesh(arr, ("model", "data"))


# Compiled-executable cache. Each distributed_* call builds a fresh
# shard_fn closure; dispatching that eagerly made XLA recompile the whole
# SPMD program EVERY call (~27 s/call on an 8-device CPU mesh, and a
# fresh compile per step in production loops). The closure is fully
# determined by its static configuration, so identical configurations
# reuse one jitted callable here — all varying values (the data shards,
# the RNG seed state) flow in as traced operands.
# Bounded LRU: long-running sweeps that vary shapes/meshes would
# otherwise accumulate compiled SPMD executables forever. Varying values
# (data shards, seed state, alpha) flow in as traced operands and are NOT
# part of the key.
from collections import OrderedDict

_FN_CACHE: OrderedDict = OrderedDict()
_FN_CACHE_MAX = 64


def _cached(key, build):
    fn = _FN_CACHE.get(key)
    if fn is None:
        fn = jax.jit(build())
        _FN_CACHE[key] = fn
        if len(_FN_CACHE) > _FN_CACHE_MAX:
            _FN_CACHE.popitem(last=False)
    else:
        _FN_CACHE.move_to_end(key)
    return fn


def _shard_extent(total: int, parts: int, align: int = 1) -> int:
    """Per-shard extent covering `total` over `parts` shards, rounded up
    to `align`: the pad-and-shard scheme. Phantom rows/columns beyond
    `total` either multiply zero-padded data or are sliced off the
    output; alignment keeps every shard's counter offset on a block
    boundary (the same trick the fused kernel's padding uses — the counter
    stride always comes from the TRUE parent extent, never the padded
    one). Counterpart of fill_dense's any-submatrix generality
    (dense_skops.hh:487-532)."""
    per = -(-total // parts)
    return -(-per // align) * align


def distributed_sketch(
    S: DenseSkOp,
    A: jax.Array,
    mesh: Mesh,
    *,
    alpha=1.0,
    use_fused="auto",
    interpret: bool = False,
) -> jax.Array:
    """B = alpha * S @ A with A m-sharded over 'data' and B d-sharded over
    'model'. Returns a global jax.Array with sharding P('model', None).

    Any (d, m, mesh) combination runs: per-shard extents are padded up to
    counter-aligned sizes (pad-and-shard) — phantom operator columns
    multiply zero-padded data rows, phantom output rows are sliced off,
    and every counter stride comes from the TRUE parent dimensions, so the
    values are bit-identical to the single-device sketch.

    use_fused: 'auto' runs the RNG-in-GEMM kernel per shard on the GPU
    where the shard shape qualifies (ops/fused_sketch.fused_profitable;
    each device generates its tile of the GLOBAL operator in-kernel: the
    global counter stride and the shard's base counter offset are folded
    into the kernel's seed); True forces it (``interpret`` runs it in
    the Pallas interpreter, for CPU tests); False uses the XLA fill+GEMM
    shard path.
    """
    require(isinstance(S, DenseSkOp), "distributed_sketch takes a DenseSkOp")
    from ..base import Layout, MajorAxis, Op
    from ..dense import DenseDistName, dist_to_layout
    from ..ops import fused_sketch as fs
    from ..rng.bits import mul64_u32, add64, ctr_add64

    d, m = S.shape
    n = A.shape[1]
    pm = mesh.shape["model"]
    pd = mesh.shape["data"]
    require(A.shape[0] == m, "A row count must equal S.n_cols")

    dist, seed, dtype = S.dist, S.seed_state, S.dtype

    # pad-and-shard: align every shard offset to the counter width so the
    # traced fill / fused kernel stays on block boundaries in BOTH layouts
    # (RowMajor lanes walk m; ColMajor lanes walk d).
    d_per = _shard_extent(d, pm, seed.len_c)
    m_per = _shard_extent(m, pd, seed.len_c)
    d_pad_g, m_pad_g = pm * d_per, pd * m_per
    if m_pad_g != m:
        A = jnp.pad(A, ((0, m_pad_g - m), (0, 0)))

    fused_ok = (
        use_fused is not False
        and dtype == jnp.float32
        and seed.rng in ("philox4x32", "threefry4x32")
        and dist.family in (DenseDistName.Gaussian, DenseDistName.Uniform)
        and dist_to_layout(dist) == Layout.RowMajor
        and m_per % 4 == 0
    )
    if use_fused == "auto":
        fused_ok = fused_ok and backend.on_gpu() and fs.fused_profitable(
            d_per, m_per, n)
    elif use_fused is True:
        require(fused_ok, "fused distributed path forced but unsupported")

    ctr_stride_global = (m + ((-m) % 4)) // 4

    def build():
        def shard_fn(a_blk, sd, al):
            mi = jax.lax.axis_index("model")
            di = jax.lax.axis_index("data")
            ro = mi.astype(jnp.uint32) * jnp.uint32(d_per)
            co = di.astype(jnp.uint32) * jnp.uint32(m_per)
            if fused_ok:
                # shard base counter = seed + ro*stride_global + co//4;
                # the kernel then walks rows with the GLOBAL stride,
                # yielding exactly this device's tile of the one global
                # operator.
                lo, hi = mul64_u32(ro, jnp.uint32(ctr_stride_global))
                lo, hi = add64(lo, hi, co // jnp.uint32(4), jnp.uint32(0))
                words = fs.seed_words(ctr_add64(sd.counter, lo, hi),
                                      sd.key)
                # fused_call plans/pads internally and carries the custom
                # VJP (the cotangent is the other orientation with the
                # same seed words), so sharded sketches differentiate.
                # alpha is a traced operand (jit-compatible, one compile
                # for all values) — applied outside the kernel.
                part = al * fs.fused_call(
                    words, a_blk, d_per,
                    dist.family == DenseDistName.Gaussian,
                    ctr_stride_global, 0, seed.rng, interpret)
                return jax.lax.psum(part, "data")
            s_blk = fill_dense_submat_traced(dist, sd, d_per, m_per, ro,
                                             co, dtype)
            part = jnp.matmul(s_blk, a_blk.astype(dtype),
                              preferred_element_type=dtype)
            return jax.lax.psum(al.astype(dtype) * part, "data")

        return jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P("data", None), P(), P()),
            out_specs=P("model", None),
            # pallas_call outputs carry no varying-mesh-axes metadata
            check_vma=not fused_ok,
        )

    key = ("left", mesh, dist, str(dtype), d, m, n, str(A.dtype),
           fused_ok, interpret, seed.rng, seed.key.shape[0])
    out = _cached(key, build)(A, seed, jnp.asarray(alpha, dtype))
    return out[:d] if d_pad_g != d else out


def distributed_sketch_jit(S: DenseSkOp, A: jax.Array, mesh: Mesh,
                           *, alpha=1.0) -> jax.Array:
    """jit-wrapped distributed_sketch with sharded output layout."""
    f = jax.jit(functools.partial(distributed_sketch, mesh=mesh,
                                  alpha=alpha),
                static_argnames=())
    return f(S, A)


def distributed_sketch_right(
    S: DenseSkOp,
    A: jax.Array,
    mesh: Mesh,
    *,
    alpha=1.0,
    use_fused="auto",
    interpret: bool = False,
) -> jax.Array:
    """B = alpha * A @ S with A (rows, m) column-sharded over 'data' and
    B (rows, d) d-sharded over 'model'.

    Each device generates its (m/data x d/model) tile of the global
    operator from counters (row offset = data index, column offset =
    model index — both fold into the traced fill) and contributes a
    partial product; partials psum over 'data'. Any shape runs: shard
    extents pad up to counter-aligned sizes (see _shard_extent) with
    phantom rows multiplying zero-padded data columns and phantom output
    columns sliced off.

    use_fused: as for distributed_sketch; tall-Long shard tiles run
    through the RNG-in-GEMM kernel on their TRANSPOSE: by the
    autotranspose property the tile's transpose is a tile of the global
    transposed (wide RowMajor) operator, so part^T = S_t_tile @ a_blk^T
    generates the operator in-kernel and never stores it.
    """
    require(isinstance(S, DenseSkOp), "takes a DenseSkOp")
    from ..base import Layout
    from ..dense import DenseDist, DenseDistName, dist_to_layout
    from ..ops import fused_sketch as fs

    m, d = S.shape
    rows = A.shape[0]
    require(A.shape[1] == m, "A column count must equal S.n_rows")
    pm = mesh.shape["model"]
    pd = mesh.shape["data"]
    d_per = _shard_extent(d, pm, S.seed_state.len_c)
    m_per = _shard_extent(m, pd, S.seed_state.len_c)
    d_pad_g, m_pad_g = pm * d_per, pd * m_per
    if m_pad_g != m:
        A = jnp.pad(A, ((0, 0), (0, m_pad_g - m)))

    dist, seed, dtype = S.dist, S.seed_state, S.dtype

    dist_t = (None if dist.family == DenseDistName.BlackBox else
              DenseDist(dist.n_cols, dist.n_rows, dist.family,
                        dist.major_axis))
    fused_ok = (
        use_fused is not False
        and dtype == jnp.float32
        and seed.rng in ("philox4x32", "threefry4x32")
        and dist_t is not None
        and dist_to_layout(dist_t) == Layout.RowMajor
        and m_per % 4 == 0
    )
    if use_fused == "auto":
        fused_ok = fused_ok and backend.on_gpu() and fs.fused_profitable(
            d_per, m_per, rows)
    elif use_fused is True:
        require(fused_ok, "fused distributed path forced but unsupported")

    from ..rng.bits import mul64_u32, add64, ctr_add64
    ctr_stride_global = (m + ((-m) % 4)) // 4  # S_t parent width = m

    def build():
        def shard_fn(a_blk, sd, al):
            mi = jax.lax.axis_index("model")
            di = jax.lax.axis_index("data")
            ro = di.astype(jnp.uint32) * jnp.uint32(m_per)
            co = mi.astype(jnp.uint32) * jnp.uint32(d_per)
            if fused_ok:
                # this shard's tile of the transposed global operator sits
                # at row offset co (d axis) / column offset ro (m axis):
                # base counter = seed + co*stride + ro//4, rows walk the
                # GLOBAL stride.
                lo, hi = mul64_u32(co, jnp.uint32(ctr_stride_global))
                lo, hi = add64(lo, hi, ro // jnp.uint32(4), jnp.uint32(0))
                words = fs.seed_words(ctr_add64(sd.counter, lo, hi),
                                      sd.key)
                part_t = fs.fused_call(
                    words, a_blk.T, d_per,
                    dist.family == DenseDistName.Gaussian,
                    ctr_stride_global, 0, seed.rng, interpret)
                return jax.lax.psum(al * part_t.T, "data")
            s_blk = fill_dense_submat_traced(dist, sd, m_per, d_per, ro,
                                             co, dtype)
            part = jnp.matmul(a_blk.astype(dtype), s_blk,
                              preferred_element_type=dtype)
            return jax.lax.psum(al.astype(dtype) * part, "data")

        return jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(None, "data"), P(), P()),
            out_specs=P(None, "model"),
            check_vma=not fused_ok,
        )

    key = ("right", mesh, dist, str(dtype), d, m, rows, str(A.dtype),
           fused_ok, interpret, seed.rng, seed.key.shape[0])
    out = _cached(key, build)(A, seed, jnp.asarray(alpha, dtype))
    return out[:, :d] if d_pad_g != d else out


def distributed_sparse_sketch(
    S: SparseSkOp,
    A: jax.Array,
    mesh: Mesh,
    *,
    alpha=1.0,
) -> jax.Array:
    """B = alpha * S @ A for a sparse-sign operator, A m-sharded over
    'data' and B d-sharded over 'model' (out sharding P('model', None)).

    Canonical wide-SASO operators (exactly vec_nnz entries per data
    column, triplets in filled() order) shard the operator itself: the
    triplets for a shard's column range are a contiguous (m_per, vec_nnz)
    slice, so rows/vals flow in with in_spec P('data', None) — no
    replication of the operator. Each device builds only ITS d_per output
    rows (the backend's wide-SASO route, skge.SASO_ROUTE, against the
    model-local row window), and partials psum over 'data' — the
    same single-collective layout as the dense path.

    Other operators (LASO, transposed/user COO order) replicate the tiny
    triplet arrays but still compute and emit only the model-local row
    block via coo_left_apply's window masking.
    """
    require(isinstance(S, SparseSkOp), "takes a SparseSkOp")
    from ..base import MajorAxis
    from ..skge import _saso_wide_apply

    s = S.filled()
    d, m = S.shape
    pm = mesh.shape["model"]
    pd = mesh.shape["data"]
    # pad-and-shard: no counter math here (triplets are explicit), so the
    # only padding needed is up to divisibility; phantom data rows carry
    # row index -1 / value 0 and phantom output rows are sliced off.
    m_per = _shard_extent(m, pd)
    d_per = _shard_extent(d, pm)
    m_pad_g, d_pad_g = pd * m_per, pm * d_per
    if m_pad_g != m:
        A = jnp.pad(A, ((0, m_pad_g - m), (0, 0)))
    k = S.dist.vec_nnz
    canonical_wide = (s.canonical and S.dist.major_axis == MajorAxis.Short
                      and d < m)

    if canonical_wide:
        rows_mk = s.rows.reshape(m, k).astype(jnp.int32)
        vals_mk = s.vals.reshape(m, k)
        if m_pad_g != m:
            rows_mk = jnp.pad(rows_mk, ((0, m_pad_g - m), (0, 0)),
                              constant_values=-1)
            vals_mk = jnp.pad(vals_mk, ((0, m_pad_g - m), (0, 0)))

        def build():
            def shard_fn(a_blk, rows_blk, vals_blk, al):
                mi = jax.lax.axis_index("model")
                ro = mi.astype(jnp.int32) * jnp.int32(d_per)
                r_loc = rows_blk - ro
                in_rng = (r_loc >= 0) & (r_loc < d_per)
                # out-of-window entries get index -1, which both wide
                # routes drop
                idx = jnp.where(in_rng, r_loc, -1)
                part = _saso_wide_apply(idx, vals_blk, a_blk, d_per, al)
                return jax.lax.psum(part, "data")

            return jax.shard_map(
                shard_fn, mesh=mesh,
                in_specs=(P("data", None), P("data", None),
                          P("data", None), P()),
                out_specs=P("model", None),
                # scan carries / one-hot iotas inside the shard are
                # unvarying inits joined with varying contributions
                check_vma=False,
            )

        key = ("sparse_canon", mesh, d, m, k, d_per, m_per, str(A.dtype),
               str(vals_mk.dtype), backend.platform())
        out = _cached(key, build)(A, rows_mk, vals_mk,
                                  jnp.asarray(alpha, A.dtype))
        return out[:d] if d_pad_g != d else out

    rows, cols, vals = s.rows, s.cols, s.vals

    def build():
        def shard_fn(a_blk, rows, cols, vals, al):
            mi = jax.lax.axis_index("model")
            di = jax.lax.axis_index("data")
            ro = mi.astype(jnp.int32) * jnp.int32(d_per)
            co = di.astype(jnp.int32) * jnp.int32(m_per)
            part = coo_left_apply(rows, cols, vals.astype(a_blk.dtype),
                                  a_blk, d_per, m_per, ro, co, al)
            return jax.lax.psum(part, "data")

        return jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P("data", None), P(), P(), P(), P()),
            out_specs=P("model", None),
            check_vma=False,
        )

    key = ("sparse_coo", mesh, d, m, d_per, m_per, rows.shape[0],
           str(A.dtype), str(vals.dtype), str(rows.dtype))
    out = _cached(key, build)(A, rows, cols, vals,
                              jnp.asarray(alpha, A.dtype))
    return out[:d] if d_pad_g != d else out


def distributed_sketch_cols(
    S: DenseSkOp,
    A: jax.Array,
    mesh: Mesh,
    *,
    alpha=1.0,
    use_fused="auto",
    interpret: bool = False,
) -> jax.Array:
    """B = alpha * S @ A with A column-sharded over 'data' — the
    "sequence-parallel" layout for huge n (the analog of sequence/context
    sharding in training frameworks; SURVEY.md §2.3).

    Zero communication: every device holds its own n-columns of A and a
    row-block of the implicit operator (d sharded over 'model', generated
    from counters at its global row offset — bit-identical to the
    single-device operator), and computes its (d/model, n/data) output
    block locally. The output is 2-D sharded, P('model', 'data'), ready
    to feed further sharded stages; on a mesh with model == 1 this reduces
    to the pure column-sharded layout. Shapes need not divide the mesh:
    pad-and-shard (see _shard_extent) slices phantom rows/columns off.

    Also accepts a TrigSkOp (SRHT): the Hadamard transform acts along
    rows, so the column layout is the one sharding where SRHT work is
    embarrassingly parallel — each device transforms its own column
    block and gathers its 'model' slice of the sampled rows (the
    m-sharded layouts would need cross-device butterflies; use the dense
    family there).
    """
    if isinstance(S, TrigSkOp):
        require(use_fused is not True,
                "SRHT has no fused RNG-in-GEMM kernel (the transform IS "
                "the apply); use_fused=True cannot be honored for a "
                "TrigSkOp")
        return _distributed_sketch_cols_trig(S, A, mesh, alpha)
    require(isinstance(S, DenseSkOp), "takes a DenseSkOp or TrigSkOp")
    from ..base import Layout
    from ..dense import DenseDistName, dist_to_layout
    from ..ops import fused_sketch as fs
    from ..rng.bits import mul64_u32, add64, ctr_add64

    d, m = S.shape
    n = A.shape[1]
    require(A.shape[0] == m, "A row count must equal S.n_cols")
    pm = mesh.shape["model"]
    pd = mesh.shape["data"]
    dist, seed, dtype = S.dist, S.seed_state, S.dtype
    d_per = _shard_extent(d, pm, seed.len_c)
    n_per = _shard_extent(n, pd)
    d_pad_g, n_pad_g = pm * d_per, pd * n_per
    if n_pad_g != n:
        A = jnp.pad(A, ((0, 0), (0, n_pad_g - n)))

    fused_ok = (
        use_fused is not False
        and dtype == jnp.float32
        and seed.rng in ("philox4x32", "threefry4x32")
        and dist.family in (DenseDistName.Gaussian, DenseDistName.Uniform)
        and dist_to_layout(dist) == Layout.RowMajor
        and m % 4 == 0
    )
    if use_fused == "auto":
        fused_ok = fused_ok and backend.on_gpu() and fs.fused_profitable(
            d_per, m, n_per)
    elif use_fused is True:
        require(fused_ok, "fused distributed path forced but unsupported")

    ctr_stride_global = (m + ((-m) % 4)) // 4

    def build():
        def shard_fn(a_blk, sd, al):
            mi = jax.lax.axis_index("model")
            ro = mi.astype(jnp.uint32) * jnp.uint32(d_per)
            if fused_ok:
                lo, hi = mul64_u32(ro, jnp.uint32(ctr_stride_global))
                words = fs.seed_words(ctr_add64(sd.counter, lo, hi),
                                      sd.key)
                return al * fs.fused_call(
                    words, a_blk, d_per,
                    dist.family == DenseDistName.Gaussian,
                    ctr_stride_global, 0, seed.rng, interpret)
            s_blk = fill_dense_submat_traced(dist, sd, d_per, m, ro,
                                             jnp.uint32(0), dtype)
            part = jnp.matmul(s_blk, a_blk.astype(dtype),
                              preferred_element_type=dtype)
            return al.astype(dtype) * part

        return jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(None, "data"), P(), P()),
            out_specs=P("model", "data"),
            check_vma=False,
        )

    key = ("cols", mesh, dist, str(dtype), d, m, n, str(A.dtype),
           fused_ok, interpret, seed.rng, seed.key.shape[0])
    out = _cached(key, build)(A, seed, jnp.asarray(alpha, dtype))
    if d_pad_g != d or n_pad_g != n:
        out = out[:d, :n]
    return out


def _distributed_sketch_cols_trig(S: TrigSkOp, A: jax.Array, mesh: Mesh,
                                  alpha) -> jax.Array:
    """Column-sharded SRHT sketch (see distributed_sketch_cols).

    The operator's randomness (signs, sampled row indices) is tiny and
    sampled ONCE on the host — every device sees the identical global
    operator; each 'model' row of the mesh gathers its slice of the
    sampled Hadamard rows, so results are bitwise equal to the
    single-device lmult per column block."""
    from ..ops.hadamard import hadamard_transform

    d, m = S.shape
    n = A.shape[1]
    require(A.ndim == 2 and A.shape[0] == m,
            "A row count must equal S.n_cols")
    pm = mesh.shape["model"]
    pd = mesh.shape["data"]
    d_per = _shard_extent(d, pm)
    n_per = _shard_extent(n, pd)
    d_pad_g, n_pad_g = pm * d_per, pd * n_per
    if n_pad_g != n:
        A = jnp.pad(A, ((0, 0), (0, n_pad_g - n)))
    signs, indices = S._sample()
    if d_pad_g != d:
        indices = jnp.pad(indices, (0, d_pad_g - d))
    m_pad = S.dist.padded_cols

    def build():
        def shard_fn(a_blk, sg, idx, al):
            mi = jax.lax.axis_index("model")
            idx_blk = jax.lax.dynamic_slice(
                idx, (mi.astype(jnp.int32) * d_per,), (d_per,))
            x = sg[:, None].astype(a_blk.dtype) * a_blk
            if m_pad != m:
                x = jnp.pad(x, ((0, m_pad - m), (0, 0)))
            h = hadamard_transform(x)
            return al.astype(h.dtype) * h[idx_blk, :]

        return jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(None, "data"), P(), P(), P()),
            out_specs=P("model", "data"),
            check_vma=False,
        )

    key = ("cols-trig", mesh, S.dist, str(S.dtype), d, m, n, str(A.dtype))
    out = _cached(key, build)(A, signs, indices,
                              jnp.asarray(alpha, A.dtype))
    if d_pad_g != d or n_pad_g != n:
        out = out[:d, :n]
    return out


def distributed_sketch_sparse_data(
    S: DenseSkOp,
    A,  # sparse matrix (COO/CSR/CSC), shape (m, n)
    mesh: Mesh,
    *,
    alpha=1.0,
) -> jax.Array:
    """B = alpha * S @ A for a *dense* operator applied to *sparse data*,
    distributed over the mesh — the multi-device counterpart of
    sketch_sparse/lsksp3 (sparse_data/sksp.hh:148-345; SURVEY.md §7.8).

    Sharding: the operator's d rows shard over 'model' (each device
    generates its counter-addressed row block of the one global operator
    — zero communication), and the contraction axis m (the sparse data's
    long axis) shards over 'data': the tiny triplet arrays are replicated
    and each device masks to its column window (the same shape-static
    filtering coo_left_apply uses, the analog of set_filtered_coo), so
    partial products psum over 'data' exactly like the dense path. Any
    shape runs (pad-and-shard).

    Returns B (d, n) with sharding P('model', None).
    """
    require(isinstance(S, DenseSkOp), "takes a DenseSkOp operator")
    from ..ops.coo_apply import coo_left_apply
    from ..sparse_data.conversions import to_coo

    coo = to_coo(A)
    m, n = coo.n_rows, coo.n_cols
    d = S.n_rows
    require(S.n_cols == m, "operator width must equal data row count")
    pm = mesh.shape["model"]
    pd = mesh.shape["data"]
    dist, seed, dtype = S.dist, S.seed_state, S.dtype
    d_per = _shard_extent(d, pm, seed.len_c)
    m_per = _shard_extent(m, pd, seed.len_c)
    d_pad_g = pm * d_per

    rows, cols = coo.rows, coo.cols
    vals = coo.vals.astype(dtype)

    def build():
        def shard_fn(rows, cols, vals, sd, al):
            mi = jax.lax.axis_index("model")
            di = jax.lax.axis_index("data")
            ro = mi.astype(jnp.uint32) * jnp.uint32(d_per)
            co = di.astype(jnp.uint32) * jnp.uint32(m_per)
            s_blk = fill_dense_submat_traced(dist, sd, d_per, m_per, ro,
                                             co, dtype)
            # part = s_blk @ A[co:co+m_per, :]; with the sparse operand on
            # the right, apply through the transpose: part^T = A_window^T
            # @ s_blk^T, a sparse-left product with the COO index roles
            # swapped (the zero-copy transposed-view trick,
            # spmm_dispatch.hh:74-76).
            part_t = coo_left_apply(cols, rows, vals, s_blk.T, d=n,
                                    m=m_per, ro=0,
                                    co=co.astype(jnp.int32), alpha=al)
            return jax.lax.psum(part_t.T, "data")

        return jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(), P(), P(), P(), P()),
            out_specs=P("model", None),
            check_vma=False,
        )

    key = ("sparse_data", mesh, dist, str(dtype), d, m, n, rows.shape[0],
           str(vals.dtype), str(rows.dtype), seed.rng,
           seed.key.shape[0])
    out = _cached(key, build)(rows, cols, vals, seed,
                              jnp.asarray(alpha, dtype))
    return out[:d] if d_pad_g != d else out
