"""Multi-device sketching tests on the 8-device virtual CPU mesh.

The key property (mesh-shape invariance, the multi-chip generalization of
the reference's thread-count-invariance test, test_denseskop.cc:300-341):
the same seed produces bitwise-identical sketches on 1x1, 1x8, 2x4, 8x1
meshes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from randblas_tpu import DenseDist, DenseSkOp, RNGState, SparseDist, \
    SparseSkOp, sketch_general
from randblas_tpu.parallel import distributed_sketch, make_sketch_mesh
from randblas_tpu.parallel.distributed import distributed_sparse_sketch

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

D, M, N = 16, 64, 8


def _setup(key=5):
    S = DenseSkOp(DenseDist(D, M), RNGState.from_key(key))
    A = jnp.asarray(
        np.random.default_rng(0).normal(size=(M, N)).astype(np.float32))
    return S, A


@pytest.mark.parametrize("model,data", [(1, 8), (2, 4), (4, 2), (8, 1),
                                        (1, 1)])
@pytest.mark.slow
def test_mesh_shape_invariance(model, data):
    S, A = _setup()
    devices = jax.devices()[:model * data]
    mesh = make_sketch_mesh(model, data, devices)
    got = np.asarray(distributed_sketch(S, A, mesh))
    want = np.asarray(sketch_general(S, A))
    # generation is bitwise invariant (see the identity test below); the
    # psum contraction reassociates the f32 sum across shards, so the
    # product matches to reduction-order tolerance only.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_single_vs_multi_bitwise_generation():
    """Generation itself (no contraction) is bitwise identical across the
    mesh: check by sketching against identity."""
    S = DenseSkOp(DenseDist(D, M), RNGState.from_key(9))
    eye = jnp.eye(M, dtype=jnp.float32)
    mesh = make_sketch_mesh(2, 4)
    got = np.asarray(distributed_sketch(S, eye, mesh))
    want = np.asarray(S.materialize())
    np.testing.assert_array_equal(got, want)


def test_output_sharding():
    S, A = _setup()
    mesh = make_sketch_mesh(2, 4)
    out = distributed_sketch(S, A, mesh)
    assert out.shape == (D, N)
    # d axis sharded over 'model'
    shard_shapes = {tuple(s.data.shape) for s in out.addressable_shards}
    assert shard_shapes == {(D // 2, N)}


@pytest.mark.parametrize("model,data", [(2, 4), (1, 8)])
def test_distributed_right(model, data):
    m, d, rows = 64, 16, 10
    S = DenseSkOp(DenseDist(m, d), RNGState.from_key(13))  # tall, Long
    A = jnp.asarray(
        np.random.default_rng(2).normal(size=(rows, m)).astype(np.float32))
    from randblas_tpu.parallel import distributed_sketch_right
    mesh = make_sketch_mesh(model, data)
    got = np.asarray(distributed_sketch_right(S, A, mesh))
    want = np.asarray(sketch_general(S, A, side="right"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model,data", [(1, 8), (2, 4), (4, 2), (8, 1)])
@pytest.mark.slow
def test_distributed_sparse(model, data):
    """Canonical wide-SASO path: operator triplets sharded over 'data',
    output rows over 'model' (no replication of either)."""
    Ss = SparseSkOp(SparseDist(D, M, vec_nnz=4), RNGState.from_key(3))
    A = jnp.asarray(
        np.random.default_rng(1).normal(size=(M, N)).astype(np.float32))
    mesh = make_sketch_mesh(model, data)
    out = distributed_sparse_sketch(Ss, A, mesh)
    # output really is d-sharded over 'model' (jit may normalize a
    # fully-replicated spec to the empty PartitionSpec when model == 1)
    if model > 1:
        assert out.sharding.spec[0] == "model"
    got = np.asarray(out)
    want = np.asarray(sketch_general(Ss, A))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_distributed_sparse_noncanonical():
    """User-supplied COO order falls back to the replicated-triplet path
    (still model-sharded output) and stays correct."""
    Ss = SparseSkOp(SparseDist(D, M, vec_nnz=4), RNGState.from_key(3))
    s = Ss.filled()
    perm = np.random.default_rng(7).permutation(s.rows.shape[0])
    shuffled = SparseSkOp(
        Ss.dist, Ss.seed_state,
        rows=jnp.asarray(np.asarray(s.rows)[perm]),
        cols=jnp.asarray(np.asarray(s.cols)[perm]),
        vals=jnp.asarray(np.asarray(s.vals)[perm]))
    A = jnp.asarray(
        np.random.default_rng(1).normal(size=(M, N)).astype(np.float32))
    mesh = make_sketch_mesh(2, 4)
    got = np.asarray(distributed_sparse_sketch(shuffled, A, mesh))
    want = np.asarray(sketch_general(Ss, A))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_distributed_fused_interpret():
    """Per-shard RNG-in-GEMM kernel (Pallas interpret mode) produces the
    same global sketch as the XLA shard path."""
    S = DenseSkOp(DenseDist(D, 512), RNGState.from_key(21))
    A = jnp.asarray(
        np.random.default_rng(3).normal(size=(512, 8)).astype(np.float32))
    mesh = make_sketch_mesh(2, 4)
    got = np.asarray(distributed_sketch(S, A, mesh, use_fused=True,
                                        interpret=True))
    want = np.asarray(distributed_sketch(S, A, mesh, use_fused=False))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-2)


def test_jit_distributed():
    S, A = _setup()
    mesh = make_sketch_mesh(2, 4)

    import functools

    f = jax.jit(functools.partial(distributed_sketch, mesh=mesh))
    got = np.asarray(f(S, A))
    want = np.asarray(sketch_general(S, A))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model,data", [(1, 8), (1, 4), (2, 4)])
def test_distributed_sketch_cols(model, data):
    """Column ("sequence") sharding: zero-collective layout — every
    device generates the same operator from counters and sketches its
    own columns; output stays column-sharded."""
    from randblas_tpu.parallel.distributed import distributed_sketch_cols
    S, A = _setup(key=17)
    devices = jax.devices()[:model * data]
    mesh = make_sketch_mesh(model, data, devices)
    out = distributed_sketch_cols(S, A, mesh)
    assert out.sharding.spec[1] == ("data" if data > 1
                                    else out.sharding.spec[1])
    want = np.asarray(sketch_general(S, A))
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("model,data,d", [(1, 8, 16), (2, 4, 16),
                                          (2, 4, 13)])
def test_distributed_sketch_cols_trig(model, data, d):
    """SRHT over the column-sharded layout: the Hadamard transform acts
    along rows, so each device transforms its own column block and
    gathers its 'model' slice of the sampled rows — zero collectives,
    any d (pad-and-shard)."""
    from randblas_tpu import TrigDist, TrigSkOp
    from randblas_tpu.parallel.distributed import distributed_sketch_cols
    S = TrigSkOp(TrigDist(d, M), RNGState.from_key(23))
    A = jnp.asarray(
        np.random.default_rng(2).normal(size=(M, N)).astype(np.float32))
    devices = jax.devices()[:model * data]
    mesh = make_sketch_mesh(model, data, devices)
    out = distributed_sketch_cols(S, A, mesh, alpha=0.5)
    want = 0.5 * np.asarray(S.materialize()) @ np.asarray(A)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-5,
                               atol=1e-4)


# -------------------- round-3 additions (VERDICT items 3, 4, 8) ------------

@pytest.mark.parametrize("model,data", [(1, 8), (2, 4), (8, 1)])
def test_distributed_sparse_data(model, data):
    """Dense operator x sparse DATA over the mesh (the distributed
    counterpart of sketch_sparse/lsksp3)."""
    from randblas_tpu.parallel import distributed_sketch_sparse_data
    from randblas_tpu.sparse_data import COOMatrix
    rng = np.random.default_rng(11)
    m, n, d = 64, 24, 16
    nnz = 150
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.normal(size=nnz).astype(np.float32)
    A = COOMatrix.from_arrays(m, n, rows, cols, vals)
    S = DenseSkOp(DenseDist(d, m), RNGState.from_key(23))
    mesh = make_sketch_mesh(model, data)
    got = np.asarray(distributed_sketch_sparse_data(S, A, mesh))
    from randblas_tpu.sksp import sketch_sparse
    want = np.asarray(sketch_sparse(S, A))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fn_kind", ["left", "right", "sparse_op",
                                     "sparse_data", "cols"])
@pytest.mark.slow
def test_pad_and_shard_non_divisible(fn_kind):
    """d=12, m=40 (and friends) on a 2x4 mesh: nothing divides, the
    pad-and-shard scheme must still match the single-device oracle
    exactly (generation) / to reduction tolerance (contraction)."""
    from randblas_tpu.parallel import (
        distributed_sketch_right, distributed_sketch_sparse_data,
        distributed_sketch_cols,
    )
    mesh = make_sketch_mesh(2, 4)
    rng = np.random.default_rng(5)
    if fn_kind == "left":
        d, m, n = 12, 40, 7
        S = DenseSkOp(DenseDist(d, m), RNGState.from_key(31))
        A = jnp.asarray(rng.normal(size=(m, n)).astype(np.float32))
        got = np.asarray(distributed_sketch(S, A, mesh))
        want = np.asarray(sketch_general(S, A))
    elif fn_kind == "right":
        m, d, rows = 40, 12, 5
        S = DenseSkOp(DenseDist(m, d), RNGState.from_key(32))
        A = jnp.asarray(rng.normal(size=(rows, m)).astype(np.float32))
        got = np.asarray(distributed_sketch_right(S, A, mesh))
        want = np.asarray(sketch_general(S, A, side="right"))
    elif fn_kind == "sparse_op":
        d, m, n = 12, 40, 7
        Ss = SparseSkOp(SparseDist(d, m, vec_nnz=3), RNGState.from_key(33))
        A = jnp.asarray(rng.normal(size=(m, n)).astype(np.float32))
        got = np.asarray(distributed_sparse_sketch(Ss, A, mesh))
        want = np.asarray(sketch_general(Ss, A))
    elif fn_kind == "sparse_data":
        from randblas_tpu.sparse_data import COOMatrix
        from randblas_tpu.sksp import sketch_sparse
        d, m, n = 12, 40, 9
        nnz = 77
        A = COOMatrix.from_arrays(
            m, n, rng.integers(0, m, nnz), rng.integers(0, n, nnz),
            rng.normal(size=nnz).astype(np.float32))
        S = DenseSkOp(DenseDist(d, m), RNGState.from_key(34))
        got = np.asarray(distributed_sketch_sparse_data(S, A, mesh))
        want = np.asarray(sketch_sparse(S, A))
    else:  # cols
        d, m, n = 12, 40, 13
        S = DenseSkOp(DenseDist(d, m), RNGState.from_key(35))
        A = jnp.asarray(rng.normal(size=(m, n)).astype(np.float32))
        got = np.asarray(distributed_sketch_cols(S, A, mesh))
        want = np.asarray(sketch_general(S, A))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cols_composes_with_model_axis():
    """distributed_sketch_cols shards d over 'model' too (no replication):
    the output is 2-D sharded P('model', 'data')."""
    from randblas_tpu.parallel import distributed_sketch_cols
    S = DenseSkOp(DenseDist(16, 64), RNGState.from_key(41))
    A = jnp.asarray(np.random.default_rng(4).normal(
        size=(64, 32)).astype(np.float32))
    mesh = make_sketch_mesh(2, 4)
    out = distributed_sketch_cols(S, A, mesh)
    spec = out.sharding.spec
    assert spec[0] == "model" and spec[1] == "data"
    want = np.asarray(sketch_general(S, A))
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-5, atol=1e-5)
    # bitwise generation invariance: identity data
    eye = jnp.eye(64, dtype=jnp.float32)
    got = np.asarray(distributed_sketch_cols(S, eye, mesh))
    np.testing.assert_array_equal(got, np.asarray(S.materialize()))


# -------------------- distributed update scenarios 1-4 ---------------------
# updates.rst:1-128 run ACROSS the mesh: seed-chained growth of d and m
# with sharded operands must equal the sharded one-shot sketch exactly
# (generation) / to psum reassociation tolerance (contraction).

def _dop(n_rows, n_cols, ma, state):
    from randblas_tpu import DenseDistName, MajorAxis
    return DenseSkOp(DenseDist(n_rows, n_cols, DenseDistName.Gaussian, ma),
                     state)


def test_distributed_update_scenario_1_grow_d():
    from randblas_tpu import MajorAxis
    mesh = make_sketch_mesh(2, 4)
    m, n, d1, d2 = 32, 6, 8, 12
    A = jnp.asarray(np.random.default_rng(0).normal(
        size=(m, n)).astype(np.float32))
    c = RNGState.from_key(51)
    S1 = _dop(d1, m, MajorAxis.Long, c)
    S2 = _dop(d2, m, MajorAxis.Long, S1.next_state)
    S = _dop(d1 + d2, m, MajorAxis.Long, c)
    two_step = np.vstack([np.asarray(distributed_sketch(S1, A, mesh)),
                          np.asarray(distributed_sketch(S2, A, mesh))])
    one_shot = np.asarray(distributed_sketch(S, A, mesh))
    np.testing.assert_allclose(two_step, one_shot, rtol=1e-6, atol=1e-6)


def test_distributed_update_scenario_2_grow_m():
    from randblas_tpu import MajorAxis
    mesh = make_sketch_mesh(2, 4)
    d, n, m1, m2 = 8, 6, 32, 24
    rng = np.random.default_rng(1)
    A1 = jnp.asarray(rng.normal(size=(m1, n)).astype(np.float32))
    A2 = jnp.asarray(rng.normal(size=(m2, n)).astype(np.float32))
    c = RNGState.from_key(52)
    S1 = _dop(d, m1, MajorAxis.Short, c)
    S2 = _dop(d, m2, MajorAxis.Short, S1.next_state)
    S = _dop(d, m1 + m2, MajorAxis.Short, c)
    B = (np.asarray(distributed_sketch(S1, A1, mesh))
         + np.asarray(distributed_sketch(S2, A2, mesh)))
    one_shot = np.asarray(distributed_sketch(S, jnp.vstack([A1, A2]), mesh))
    np.testing.assert_allclose(B, one_shot, rtol=1e-5, atol=1e-5)


def test_distributed_update_scenario_3_grow_d_right():
    from randblas_tpu import MajorAxis
    from randblas_tpu.parallel import distributed_sketch_right
    mesh = make_sketch_mesh(2, 4)
    n, rows, d1, d2 = 32, 5, 8, 12
    A = jnp.asarray(np.random.default_rng(2).normal(
        size=(rows, n)).astype(np.float32))
    c = RNGState.from_key(53)
    S1 = _dop(n, d1, MajorAxis.Long, c)
    S2 = _dop(n, d2, MajorAxis.Long, S1.next_state)
    S = _dop(n, d1 + d2, MajorAxis.Long, c)
    two_step = np.hstack([
        np.asarray(distributed_sketch_right(S1, A, mesh)),
        np.asarray(distributed_sketch_right(S2, A, mesh))])
    one_shot = np.asarray(distributed_sketch_right(S, A, mesh))
    np.testing.assert_allclose(two_step, one_shot, rtol=1e-6, atol=1e-6)


def test_distributed_update_scenario_4_new_data_right():
    from randblas_tpu import MajorAxis
    from randblas_tpu.parallel import distributed_sketch_right
    mesh = make_sketch_mesh(2, 4)
    d, rows, n1, n2 = 8, 5, 32, 24
    rng = np.random.default_rng(3)
    A1 = jnp.asarray(rng.normal(size=(rows, n1)).astype(np.float32))
    A2 = jnp.asarray(rng.normal(size=(rows, n2)).astype(np.float32))
    c = RNGState.from_key(54)
    S1 = _dop(n1, d, MajorAxis.Short, c)
    S2 = _dop(n2, d, MajorAxis.Short, S1.next_state)
    S = _dop(n1 + n2, d, MajorAxis.Short, c)
    B = (np.asarray(distributed_sketch_right(S1, A1, mesh))
         + np.asarray(distributed_sketch_right(S2, A2, mesh)))
    one_shot = np.asarray(
        distributed_sketch_right(S, jnp.hstack([A1, A2]), mesh))
    np.testing.assert_allclose(B, one_shot, rtol=1e-5, atol=1e-5)


def test_distributed_sketch_grad():
    """jax.grad flows through the sharded sketch (staged shard path —
    pure XLA inside shard_map)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = make_sketch_mesh(2, 4)
    S = DenseSkOp(DenseDist(16, 32), RNGState.from_key(77))
    A = jnp.asarray(np.random.default_rng(7).normal(
        size=(32, 8)).astype(np.float32))
    A = jax.device_put(A, NamedSharding(mesh, P("data", None)))
    g = jax.grad(lambda a: jnp.sum(distributed_sketch(S, a, mesh) ** 2))(A)
    g_ref = jax.grad(lambda a: jnp.sum((S.materialize() @ a) ** 2))(
        jax.device_get(A))
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_distributed_fused_grad_all_layouts():
    """jax.grad through the FUSED shard branches (forced, in interpret
    mode on the CPU mesh): fused_call's cotangent is the kernel's other
    orientation with the same seed words (ops/fused_sketch.py)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from randblas_tpu.parallel import (distributed_sketch_cols,
                                       distributed_sketch_right)
    mesh = make_sketch_mesh(2, 4)
    rng = np.random.default_rng(11)
    S = DenseSkOp(DenseDist(16, 32), RNGState.from_key(1))

    def _close(got, want):          # max-normalized
        got, want = np.asarray(got), np.asarray(want)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, atol=2e-2)

    A = jnp.asarray(rng.normal(size=(32, 8)).astype(np.float32))
    Ash = jax.device_put(A, NamedSharding(mesh, P("data", None)))
    g = jax.grad(lambda a: jnp.sum(
        distributed_sketch(S, a, mesh, use_fused=True,
                           interpret=True) ** 2))(Ash)
    g_ref = jax.grad(lambda a: jnp.sum((S.materialize() @ a) ** 2))(A)
    _close(g, g_ref)

    Sr = DenseSkOp(DenseDist(32, 8), RNGState.from_key(2))
    Ar = jnp.asarray(rng.normal(size=(6, 32)).astype(np.float32))
    Arsh = jax.device_put(Ar, NamedSharding(mesh, P(None, "data")))
    gr = jax.grad(lambda a: jnp.sum(
        distributed_sketch_right(Sr, a, mesh, use_fused=True,
                                 interpret=True) ** 2))(Arsh)
    gr_ref = jax.grad(lambda a: jnp.sum((a @ Sr.materialize()) ** 2))(Ar)
    _close(gr, gr_ref)

    Ac = jnp.asarray(rng.normal(size=(32, 16)).astype(np.float32))
    Acsh = jax.device_put(Ac, NamedSharding(mesh, P(None, "data")))
    gc = jax.grad(lambda a: jnp.sum(
        distributed_sketch_cols(S, a, mesh, use_fused=True,
                                interpret=True) ** 2))(Acsh)
    gc_ref = jax.grad(lambda a: jnp.sum((S.materialize() @ a) ** 2))(Ac)
    _close(gc, gc_ref)


def test_distributed_alpha_traced_and_cache_stable():
    """alpha is a traced operand: jit with alpha as an argument works,
    and distinct alpha values do not grow the compiled-executable cache
    (code-review finding)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from randblas_tpu.parallel import distributed as dmod
    mesh = make_sketch_mesh(2, 4)
    S = DenseSkOp(DenseDist(16, 32), RNGState.from_key(91))
    A = jnp.asarray(np.random.default_rng(9).normal(
        size=(32, 8)).astype(np.float32))
    A = jax.device_put(A, NamedSharding(mesh, P("data", None)))
    f = jax.jit(lambda a, al: distributed_sketch(S, a, mesh, alpha=al))
    o1 = np.asarray(f(A, jnp.float32(2.0)))
    o2 = np.asarray(f(A, jnp.float32(-0.5)))
    base = np.asarray(S.materialize()) @ jax.device_get(A)
    np.testing.assert_allclose(o1, 2.0 * base, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o2, -0.5 * base, rtol=1e-5, atol=1e-5)
    n0 = len(dmod._FN_CACHE)
    distributed_sketch(S, A, mesh, alpha=3.25)
    distributed_sketch(S, A, mesh, alpha=7.5)
    assert len(dmod._FN_CACHE) - n0 <= 1   # one entry, reused across alphas


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_distributed_sparse_kernel_shard_body_interpret(platform,
                                                        monkeypatch):
    """Both wide-SASO routes inside the shard_map body (the backend's
    route, skge.SASO_ROUTE; the GPU's one-hot panels are plain XLA, so
    pretending the backend is "gpu" runs them on the CPU mesh), with the
    out-of-window rows of each 'model' shard dropped."""
    import randblas_tpu as rb
    monkeypatch.setattr(rb.backend, "platform", lambda: platform)
    Ss = SparseSkOp(SparseDist(D, M, vec_nnz=4), RNGState.from_key(3))
    A = jnp.asarray(
        np.random.default_rng(1).normal(size=(M, N)).astype(np.float32))
    mesh = make_sketch_mesh(2, 4)
    got = np.asarray(distributed_sparse_sketch(Ss, A, mesh))
    want = np.asarray(Ss.materialize()) @ np.asarray(A)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_tensor_sketch_column_sharded_zero_comm():
    """TensorSketch over column-sharded factors: n is the Khatri-Rao
    batch axis, so sharding the factor COLUMNS P('data') keeps every
    stage (CountSketch apply, rfft, spectral product, irfft) shard-
    local — values must be bitwise what the unsharded call produces,
    on any mesh shape (the tensor-family analog of
    distributed_sketch_cols' zero-collective layout)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from randblas_tpu import tensor_sketch

    rng = np.random.default_rng(9)
    dims, d, n = (48, 32), 64, 16
    mats = [jnp.asarray(rng.normal(size=(m, n)).astype(np.float32))
            for m in dims]
    st = RNGState.from_key(11)
    want, nxt = tensor_sketch(mats, d, st)

    for model, data in ((2, 4), (1, 8)):
        mesh = make_sketch_mesh(model, data)
        sharded = [jax.device_put(a, NamedSharding(mesh, P(None, "data")))
                   for a in mats]
        got, nxt2 = tensor_sketch(sharded, d, st)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert nxt2.to_dict() == nxt.to_dict()

def test_kfjlt_column_sharded_zero_comm():
    """KFJLT over column-sharded factors: every stage (per-mode sign
    scale, pad, Hadamard matmuls along rows, sampled-row gather,
    elementwise product) acts independently per column, so factors
    sharded P(None, 'data') produce bitwise the unsharded result with
    zero collectives — the KFJLT analog of the TensorSketch test
    above."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from randblas_tpu import kfjlt_sketch

    rng = np.random.default_rng(10)
    dims, d, n = (48, 20), 64, 16
    mats = [jnp.asarray(rng.normal(size=(m, n)).astype(np.float32))
            for m in dims]
    st = RNGState.from_key(12)
    want, nxt = kfjlt_sketch(mats, d, st)

    for model, data in ((2, 4), (1, 8)):
        mesh = make_sketch_mesh(model, data)
        sharded = [jax.device_put(a, NamedSharding(mesh, P(None, "data")))
                   for a in mats]
        got, nxt2 = kfjlt_sketch(sharded, d, st)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert nxt2.to_dict() == nxt.to_dict()
