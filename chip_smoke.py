"""Smoke test of the sketching library on one GPU, through its public API.

Each phase runs on the card at a real size and compares with a plain
reference: the operator materialized by ``fill_dense`` /
``S.materialize()`` and multiplied at ``Precision.HIGHEST`` (float64 for
config 1). A default-precision f32 product runs at TF32 on the GPU, so
the f32 phases carry a normwise relative bound of 1.5e-3 (measured
errors sit near 3e-4 to 5e-4 at these contraction lengths). Phases:

  (a) Random123 known-answer vectors and counter addressing, bitwise
  (b) headline dense sketch d=1024, m=65536, n=4096 (A is 1 GiB)
  (c) tall-skinny d=1024, m=2^20, n=128: RNG-in-GEMM kernel and staged
  (d) config 1: f64 TLS shape, 100,000 x 2,000, d=4,002
  (e) config 3: SASO sketch, vec_nnz=8
  (f) configs 4 and 4b: COO and BlockedELL data, 20,000 x 10,000, d=512
  (g) config 5: sketch_symmetric, sketch_vector, QB on a 12,288^2 matrix
  (h) jax.grad through sketch_general against S^T g
  (i) the GPU test tier (tests/test_gpu_hardware.py, marker gpu)

``--four`` runs only the multi-device path on four GPUs, each result
against its single-device counterpart: distributed_sketch on 1x4 and 2x2
meshes, distributed_sketch_right, distributed_sparse_sketch and
distributed_rsvd.

Run: python chip_smoke.py [--four]
The last line of output is one JSON object with the device; any failed
phase raises, and a machine without a GPU exits non-zero before any
phase.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TF32_REL = 1.5e-3


def _rel(x, y):
    import jax.numpy as jnp
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    return float(jnp.linalg.norm(x - y) / jnp.linalg.norm(y))


def check(phase, what, err, bound):
    ok = err <= bound
    print(f"phase ({phase}) {what}: error {err:.3e} <= bound {bound:.1e} "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise AssertionError(f"phase ({phase}) {what}: {err} > {bound}")


def _hi_matmul(a, b):
    import jax
    import jax.numpy as jnp
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _normal(shape, seed, dtype=None):
    import jax
    import jax.numpy as jnp
    return jax.random.normal(jax.random.key(seed), shape,
                             dtype or jnp.float32)


def phase_a():
    """Random123 KAT vectors on the card, and block == slice, bitwise."""
    import jax
    import jax.numpy as jnp
    import randblas_tpu as rb
    from randblas_tpu.rng.philox import philox2x32, philox4x32
    from randblas_tpu.rng.threefry import threefry2x32, threefry4x32

    fns = {"philox4x32": philox4x32, "philox2x32": philox2x32,
           "threefry4x32": threefry4x32, "threefry2x32": threefry2x32}
    path = os.path.join(ROOT, "tests", "data", "r123_kat_vectors.txt")
    bad = {}
    for line in open(path):
        toks = line.split("#")[0].split()
        if not toks or toks[0] not in fns:
            continue
        name, rounds = toks[0], int(toks[1])
        n = int(name[-4])
        n_key = n // 2 if name.startswith("philox") else n
        words = [int(w, 16) for w in toks[2:]]
        ctr = jnp.asarray(words[:n], jnp.uint32)
        key = jnp.asarray(words[n:n + n_key], jnp.uint32)
        # eager: op-by-op on the card, no compile of every round count
        got = np.asarray(fns[name](ctr, key, rounds))
        want = np.asarray(words[n + n_key:], np.uint32)
        bad[name] = bad.get(name, 0) + int((got != want).sum())
    assert len(bad) == 4, bad
    for name, n_bad in bad.items():
        check("a", f"{name} KAT vectors, mismatched words", n_bad, 0)
    for dist in (rb.DenseDist(1024, 65536),
                 rb.DenseDist(1024, 65536, major_axis=rb.MajorAxis.Short)):
        st = rb.RNGState.from_key(11)
        full = rb.fill_dense_submat(dist, st, 1024, 65536, 0, 0)
        blk = rb.fill_dense_submat(dist, st, 301, 20001, 99, 1001)
        want = full[99:400, 1001:21002]
        check("a", f"{dist.major_axis.name} block vs slice, differing bits",
              int(jnp.sum(jax.lax.bitcast_convert_type(blk, jnp.uint32)
                          != jax.lax.bitcast_convert_type(want,
                                                          jnp.uint32))), 0)


def phase_b():
    """Headline dense sketch: compile time, memory, error."""
    import jax
    import randblas_tpu as rb

    d, m, n = 1024, 65536, 4096
    S = rb.DenseSkOp(rb.DenseDist(d, m), rb.RNGState.from_key(1))
    A = _normal((m, n), 1)
    step = jax.jit(lambda a: rb.sketch_general(S, a))
    t0 = time.perf_counter()
    compiled = step.lower(A).compile()
    print(f"phase (b) compile seconds: {time.perf_counter() - t0:.2f}")
    print(f"phase (b) memory_analysis: {compiled.memory_analysis()}")
    B = jax.block_until_ready(compiled(A))
    t0 = time.perf_counter()
    B = jax.block_until_ready(compiled(A))
    print(f"phase (b) step seconds: {time.perf_counter() - t0:.6f}")
    ref = _hi_matmul(rb.fill_dense(S.dist, S.seed_state)[0], A)
    assert B.shape == (d, n) and bool(jax.numpy.isfinite(B).all())
    check("b", "headline sketch vs HIGHEST reference", _rel(B, ref),
          TF32_REL)


def phase_c():
    """Tall-skinny: the auto route (the kernel) and the staged route."""
    import jax
    import randblas_tpu as rb

    d, m, n = 1024, 1 << 20, 128
    A = _normal((m, n), 2)
    for axis in (rb.MajorAxis.Long, rb.MajorAxis.Short):
        S = rb.DenseSkOp(rb.DenseDist(d, m, major_axis=axis),
                         rb.RNGState.from_key(2))
        ref = _hi_matmul(rb.fill_dense(S.dist, S.seed_state)[0], A)
        outs = {}
        for flag in ("auto", True, False):
            with rb.flags(use_fused=flag):
                outs[flag] = jax.jit(lambda a: rb.sketch_general(S, a))(A)
        for flag, name in (("auto", "auto"), (True, "kernel"),
                           (False, "staged")):
            check("c", f"{axis.name} {name} route vs HIGHEST reference",
                  _rel(outs[flag], ref), TF32_REL)
        same = bool((outs["auto"] == outs[True]).all())
        print(f"phase (c) {axis.name}: auto dispatch took the "
              f"{'kernel' if same else 'staged path'}")


def phase_d():
    """Config 1: f64 TLS shape."""
    import jax
    import jax.numpy as jnp
    import randblas_tpu as rb

    jax.config.update("jax_enable_x64", True)
    try:
        m, n = 100_000, 2_000
        d = 2 * (n + 1)
        A = _normal((m, n), 3, jnp.float64)
        S = rb.DenseSkOp(rb.DenseDist(d, m), rb.RNGState.from_key(3),
                         dtype=jnp.float64)
        B = jax.jit(lambda a: rb.sketch_general(S, a))(A)
        ref = _hi_matmul(S.materialize(), A)
        err = float(jnp.linalg.norm(B - ref) / jnp.linalg.norm(ref))
        assert B.dtype == jnp.float64
        check("d", "f64 TLS sketch vs f64 reference", err, 1e-12)
    finally:
        jax.config.update("jax_enable_x64", False)


def phase_e():
    """Config 3: SASO sketch, vec_nnz=8."""
    import jax
    import randblas_tpu as rb

    d, m, n = 1024, 65536, 2048
    S = rb.SparseSkOp(rb.SparseDist(d, m, vec_nnz=8),
                      rb.RNGState.from_key(4))
    A = _normal((m, n), 4)
    B = jax.jit(lambda a: rb.sketch(S, a))(A)
    check("e", "SASO sketch vs HIGHEST reference",
          _rel(B, _hi_matmul(S.materialize(), A)), TF32_REL)


def phase_f():
    """Configs 4 and 4b: sparse data through COO and BlockedELL."""
    import jax
    import jax.numpy as jnp
    import randblas_tpu as rb
    from randblas_tpu.sparse_data import COOMatrix, ELLMatrix

    m, n, d = 20_000, 10_000, 512
    rng = np.random.default_rng(5)
    nnz = (m * n) // 200
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.normal(size=nnz).astype(np.float32)
    A = COOMatrix.from_arrays(m, n, rows, cols, vals)
    dense = np.zeros((m, n), np.float32)
    np.add.at(dense, (rows, cols), vals)
    dense = jnp.asarray(dense)
    S4 = rb.DenseSkOp(rb.DenseDist(d, m), rb.RNGState.from_key(5))
    B = jax.jit(lambda sp: rb.sketch_sparse(S4, sp))(A)
    check("f", "config 4 COO sketch_sparse vs HIGHEST reference",
          _rel(B, _hi_matmul(S4.materialize(), dense)), TF32_REL)
    bell = ELLMatrix.from_coo(A).blocked(word_major=4)
    S4b = rb.DenseSkOp(rb.DenseDist(n, d), rb.RNGState.from_key(6))
    B = jax.jit(lambda sp: rb.sketch_sparse(S4b, sp, side="right"))(bell)
    check("f", "config 4b BlockedELL sketch_sparse vs HIGHEST reference",
          _rel(B, _hi_matmul(dense, S4b.materialize())), TF32_REL)


def phase_g():
    """Config 5: symmetric and vector sketches, then the QB step."""
    import jax
    import jax.numpy as jnp
    import randblas_tpu as rb
    from randblas_tpu.linalg import qb_decompose

    nq, k = 12_288, 256
    G = _normal((nq, nq), 7)
    A = (G + G.T) * 0.5
    del G
    S = rb.DenseSkOp(rb.DenseDist(k, nq), rb.RNGState.from_key(7))
    Smat = S.materialize()
    B = jax.jit(lambda a: rb.sketch_symmetric(S, a))(A)
    check("g", "sketch_symmetric vs HIGHEST reference",
          _rel(B, _hi_matmul(Smat, A)), TF32_REL)
    y = jax.jit(lambda x: rb.sketch_vector(S, x))(A[:, 0])
    check("g", "sketch_vector vs HIGHEST reference",
          _rel(y, _hi_matmul(Smat, A[:, 0])), TF32_REL)
    q, b = jax.jit(lambda a: qb_decompose(a, k, rb.RNGState.from_key(8)))(A)
    orth = float(jnp.linalg.norm(_hi_matmul(q.T, q) - jnp.eye(k), 2))
    check("g", "QB ||Q^T Q - I||_2", orth, 1e-3)
    check("g", "QB B vs HIGHEST Q^T A", _rel(b, _hi_matmul(q.T, A)),
          TF32_REL)


def phase_h():
    """jax.grad through sketch_general equals S^T g, on both routes."""
    import jax
    import jax.numpy as jnp
    import randblas_tpu as rb

    d, m, n = 1024, 1 << 20, 128
    S = rb.DenseSkOp(rb.DenseDist(d, m), rb.RNGState.from_key(9))
    A = _normal((m, n), 9)
    W = _normal((d, n), 10)
    want = _hi_matmul(rb.fill_dense(S.dist, S.seed_state)[0].T, W)
    for flag in (True, False):
        with rb.flags(use_fused=flag):
            g = jax.jit(jax.grad(lambda a: jnp.sum(
                rb.sketch_general(S, a) * W)))(A)
        check("h", f"grad ({'kernel' if flag else 'staged'}) vs S^T g",
              _rel(g, want), TF32_REL)


def phase_i():
    """The GPU test tier, in this process (one process holds the card)."""
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "--rootdir", ROOT,
                      os.path.join(ROOT, "tests", "test_gpu_hardware.py")])
    check("i", "GPU tier pytest exit code", int(rc), 0)


def four():
    """The multi-device path on four GPUs against single-device results."""
    import jax
    import jax.numpy as jnp
    import randblas_tpu as rb
    from randblas_tpu.linalg import distributed_rsvd, rsvd
    from randblas_tpu.parallel import (distributed_sketch,
                                       distributed_sketch_right,
                                       distributed_sparse_sketch,
                                       make_sketch_mesh)

    assert len(jax.devices()) == 4, jax.devices()
    d, m, n = 1024, 65536, 4096
    S = rb.DenseSkOp(rb.DenseDist(d, m), rb.RNGState.from_key(21))
    A = _normal((m, n), 21)
    one = jax.jit(lambda a: rb.sketch_general(S, a))(A)
    for shape in ((1, 4), (2, 2)):
        mesh = make_sketch_mesh(*shape)
        got = distributed_sketch(S, A, mesh)
        check("four", f"distributed_sketch {shape[0]}x{shape[1]} vs one "
              f"device", _rel(got, one), TF32_REL)
    St = rb.DenseSkOp(rb.DenseDist(m, d), rb.RNGState.from_key(22))
    At = _normal((n, m), 22)
    one = jax.jit(lambda a: rb.sketch_general(St, a, side="right"))(At)
    got = distributed_sketch_right(St, At, make_sketch_mesh(2, 2))
    check("four", "distributed_sketch_right 2x2 vs one device",
          _rel(got, one), TF32_REL)
    Ss = rb.SparseSkOp(rb.SparseDist(1024, 65536, vec_nnz=8),
                       rb.RNGState.from_key(23))
    As = _normal((65536, 2048), 23)
    one = jax.jit(lambda a: rb.sketch(Ss, a))(As)
    got = distributed_sparse_sketch(Ss, As, make_sketch_mesh(1, 4))
    check("four", "distributed_sparse_sketch 1x4 vs one device",
          _rel(got, one), TF32_REL)
    mr, nr, k = 65536, 2048, 64
    u = jnp.linalg.qr(_normal((mr, k), 24))[0]
    v = jnp.linalg.qr(_normal((nr, k), 25))[0]
    s_true = jnp.linspace(10.0, 1.0, k)
    Ar = (u * s_true) @ v.T + 1e-4 * _normal((mr, nr), 26)
    mesh = make_sketch_mesh(1, 4)
    _, s4, _ = distributed_rsvd(Ar, k, rb.RNGState.from_key(27), mesh)
    _, s1, _ = rsvd(Ar, k, rb.RNGState.from_key(27))
    check("four", "distributed_rsvd singular values vs one device",
          float(jnp.max(jnp.abs(s4 - s1) / s1)), 1e-3)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-GPU path")
    args = parser.parse_args()

    import jax
    from randblas_tpu.bench_util import (device_info, nvidia_smi,
                                         require_gpu, use_compile_cache)
    print(f"compile cache: {use_compile_cache()}", flush=True)
    require_gpu()
    print(nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    if args.four:
        four()
    else:
        for phase in (phase_a, phase_b, phase_c, phase_d, phase_e,
                      phase_f, phase_g, phase_h, phase_i):
            t = time.perf_counter()
            phase()
            print(f"{phase.__name__} seconds: "
                  f"{time.perf_counter() - t:.1f}", flush=True)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
    print(f"total seconds: {time.perf_counter() - t0:.1f}")
    print(json.dumps({"ok": True, "device": device_info()}))


if __name__ == "__main__":
    sys.exit(main())
