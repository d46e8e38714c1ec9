"""Measure the GPU dispatch choices the library makes, on one GPU.

Each phase times the candidate routes for one decision through the
public entry points, in one process, on one card, at the shapes the
decision is made for, and prints one JSON line per route:

  fused   RNG-in-GEMM kernel vs staged fill + GEMM (sketch_general with
          use_fused=True / False) at the headline shape (d=1024,
          m=65536, n=4096) and the tall-skinny shape (d=1024, m=2^20,
          n=128), f32 at TF32, beside a plain GEMM of the
          pre-materialized operator at the same precision;
  crossover  the same comparison around the tall-skinny shape (n, m, d);
  tiles   the kernel's tile and launch settings at the tall-skinny shape;
  saso    config 3 (d=1024, m=65536, n=2048, vec_nnz=8): one-hot panels
          vs per-slot segment-sums;
  sparse  config 4 (m=20000, n=10000, d=512, ~1e6 nonzeros): the COO
          route, the BlockedELL route and cuSPARSE through
          jax.experimental.sparse (BCSR), as a finding only.

Run: python benchmarks/kernel_choice.py [phase ...]   (default: all)
Times are host-clock medians around block_until_ready after warm-up
(bench_util.time_host); results also go to chiprun_out/kernel_choice.jsonl.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

OUT = os.path.join("chiprun_out", "kernel_choice.jsonl")


def emit(rec):
    line = json.dumps(rec)
    print(line, flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def _rel(x, y):
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


def dense_sketch_fn(d, m, use_fused, major_axis=None):
    import jax.numpy as jnp
    import randblas_tpu as rb

    def fn(ctr, a):
        dist = rb.DenseDist(d, m) if major_axis is None else \
            rb.DenseDist(d, m, major_axis=major_axis)
        st = rb.RNGState.from_arrays(ctr, jnp.zeros(2, jnp.uint32))
        with rb.flags(use_fused=use_fused):
            return rb.sketch_general(rb.DenseSkOp(dist, st), a)
    return fn


def phase_fused(dev, shapes=((1024, 65536, 4096, "Long"),
                             (1024, 1 << 20, 128, "Long"),
                             (1024, 1 << 20, 128, "Short"))):
    """major axis Long makes these wide operators RowMajor-natural
    (stride_axis 0), Short makes them ColMajor-natural (stride_axis 1)."""
    import jax
    import jax.numpy as jnp
    import randblas_tpu as rb
    from randblas_tpu.bench_util import time_host

    ctr = jnp.zeros(4, jnp.uint32)
    for d, m, n, axis in shapes:
        ma = getattr(rb.MajorAxis, axis)
        a = jax.random.normal(jax.random.key(0), (m, n), jnp.float32)
        flops = 2.0 * d * m * n
        res = {}
        outs = {}
        for name, uf in (("staged", False), ("fused", True),
                         ("staged", False), ("fused", True)):
            fn = dense_sketch_fn(d, m, uf, ma)
            outs[name] = jax.jit(fn)(ctr, a)
            t = time_host(fn, ctr, a)
            res.setdefault(name, []).append(t)
        smat, _ = rb.fill_dense(rb.DenseDist(d, m, major_axis=ma),
                                rb.RNGState.from_key(0))
        t_gemm = time_host(lambda s, x: jnp.matmul(s, x), smat, a)
        ref = jnp.matmul(smat, a, precision=jax.lax.Precision.HIGHEST)
        del smat
        for name in ("staged", "fused"):
            t = min(res[name])
            emit({"phase": "fused", "route": name, "d": d, "m": m, "n": n,
                  "major_axis": axis, "seconds": t, "all_seconds": res[name],
                  "tflops": flops / t / 1e12,
                  "rel_err_vs_highest": _rel(outs[name], ref), **dev})
        emit({"phase": "fused", "route": "gemm_prematerialized", "d": d,
              "m": m, "n": n, "major_axis": axis, "seconds": t_gemm,
              "tflops": flops / t_gemm / 1e12, **dev})
        del a, ref, outs


def phase_tiles(dev, d=1024, m=1 << 20, n=128):
    import jax
    import jax.numpy as jnp
    from randblas_tpu.bench_util import time_host
    from randblas_tpu.ops import fused_sketch as fs

    ctr = jnp.zeros(4, jnp.uint32)
    a = jax.random.normal(jax.random.key(0), (m, n), jnp.float32)
    saved = (dict(fs.TILES), fs._NUM_WARPS, fs._NUM_STAGES,
             fs._TARGET_PROGRAMS)
    for ti, tk, warps, stages, progs in (
            (16, 64, 4, 2, 528), (16, 64, 4, 2, 1056), (16, 64, 4, 2, 2112),
            (16, 64, 4, 2, 4224), (16, 64, 8, 2, 1056), (32, 64, 4, 2, 2112)):
        fs.TILES[0] = (ti, tk)
        fs._NUM_WARPS, fs._NUM_STAGES = warps, stages
        fs._TARGET_PROGRAMS = progs
        try:
            t = time_host(dense_sketch_fn(d, m, True), ctr, a)
            emit({"phase": "tiles", "ti": ti, "tk": tk, "warps": warps,
                  "stages": stages, "programs": progs, "seconds": t,
                  "tflops": 2.0 * d * m * n / t / 1e12, **dev})
        except Exception as e:  # a refused tile is a finding, not a crash
            emit({"phase": "tiles", "ti": ti, "tk": tk, "warps": warps,
                  "stages": stages, "programs": progs,
                  "error": repr(e)[:300], **dev})
    fs.TILES.clear()
    fs.TILES.update(saved[0])
    fs._NUM_WARPS, fs._NUM_STAGES, fs._TARGET_PROGRAMS = saved[1:]


def phase_saso(dev, d=1024, m=65536, n=2048, k=8):
    import jax
    import jax.numpy as jnp
    import randblas_tpu as rb
    from randblas_tpu.bench_util import time_host
    from randblas_tpu.ops.coo_apply import (fixed_nnz_left_apply,
                                            onehot_panel_apply)

    S = rb.SparseSkOp(rb.SparseDist(d, m, vec_nnz=k),
                      rb.RNGState.from_key(2))
    s = S.filled()
    idx, w = s.rows.reshape(m, k), s.vals.reshape(m, k)
    a = jax.random.normal(jax.random.key(2), (m, n), jnp.float32)
    ref = jnp.matmul(S.materialize(), a,
                     precision=jax.lax.Precision.HIGHEST)
    for name, f in (("onehot", onehot_panel_apply),
                    ("segsum", fixed_nnz_left_apply)):
        fn = lambda i, v, x, f=f: f(i, v, x, d)  # noqa: E731
        out = jax.jit(fn)(idx, w, a)
        t = time_host(fn, idx, w, a)
        emit({"phase": "saso", "route": name, "d": d, "m": m, "n": n,
              "k": k, "seconds": t, "rel_err_vs_highest": _rel(out, ref),
              **dev})
    t = time_host(lambda x: rb.sketch(S, x), a)
    emit({"phase": "saso", "route": "sketch_general", "d": d, "m": m,
          "n": n, "k": k, "seconds": t, **dev})


def phase_sparse(dev, m=20_000, n=10_000, d=512):
    import jax
    import jax.numpy as jnp
    from jax.experimental import sparse as jsp
    import randblas_tpu as rb
    from randblas_tpu.bench_util import time_host
    from randblas_tpu.sparse_data import COOMatrix, ELLMatrix

    rng = np.random.default_rng(3)
    nnz = (m * n) // 200
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.normal(size=nnz).astype(np.float32)
    A = COOMatrix.from_arrays(m, n, rows, cols, vals)
    bell = ELLMatrix.from_coo(A).blocked(word_major=4)
    dense = np.zeros((m, n), np.float32)
    np.add.at(dense, (rows, cols), vals)
    S = rb.DenseSkOp(rb.DenseDist(n, d), rb.RNGState.from_key(4))
    s_blk = S.materialize()
    ref = jnp.matmul(jnp.asarray(dense), s_blk,
                     precision=jax.lax.Precision.HIGHEST)
    # config 4: S (d x m) @ A  (left); config 4b: A @ S (n x d) (right)
    S4 = rb.DenseSkOp(rb.DenseDist(d, m), rb.RNGState.from_key(5))
    t = time_host(lambda sp: rb.sketch_sparse(S4, sp), A)
    emit({"phase": "sparse", "route": "coo_left_sketch_sparse", "m": m,
          "n": n, "d": d, "nnz": nnz, "seconds": t, **dev})
    out = jax.jit(lambda sp: rb.sketch_sparse(S, sp, side="right"))(bell)
    t = time_host(lambda sp: rb.sketch_sparse(S, sp, side="right"), bell)
    emit({"phase": "sparse", "route": "blocked_ell_right_sketch_sparse",
          "m": m, "n": n, "d": d, "nnz": nnz, "seconds": t,
          "rel_err_vs_highest": _rel(out, ref), **dev})
    out = jax.jit(lambda sp: rb.sketch_sparse(S, sp, side="right"))(A)
    t = time_host(lambda sp: rb.sketch_sparse(S, sp, side="right"), A)
    emit({"phase": "sparse", "route": "coo_right_sketch_sparse", "m": m,
          "n": n, "d": d, "nnz": nnz, "seconds": t,
          "rel_err_vs_highest": _rel(out, ref), **dev})
    bcsr = jsp.BCSR.fromdense(jnp.asarray(dense))
    out = jax.jit(lambda sp, s: sp @ s)(bcsr, s_blk)
    t = time_host(lambda sp, s: sp @ s, bcsr, s_blk)
    emit({"phase": "sparse", "route": "bcsr_cusparse_right", "m": m,
          "n": n, "d": d, "nnz": nnz, "seconds": t,
          "rel_err_vs_highest": _rel(out, ref), **dev})


def phase_crossover(dev):
    """Where the kernel stops paying: n, m and d around the measured
    tall-skinny point."""
    phase_fused(dev, shapes=tuple(
        (d, m, n, "Long") for d, m, n in (
            (1024, 1 << 18, 128), (1024, 1 << 19, 128), (256, 1 << 20, 128),
            (1024, 1 << 20, 64), (1024, 1 << 20, 256),
            (4096, 1 << 18, 128))))


PHASES = {"fused": phase_fused, "crossover": phase_crossover,
          "tiles": phase_tiles, "saso": phase_saso, "sparse": phase_sparse}


def main():
    from randblas_tpu.bench_util import (device_info, nvidia_smi,
                                         require_gpu, use_compile_cache)
    use_compile_cache()
    require_gpu()
    card = nvidia_smi()
    print(card, flush=True)
    dev = {"device": device_info(), "card": card}
    for name in (sys.argv[1:] or list(PHASES)):
        PHASES[name](dev)


if __name__ == "__main__":
    main()
