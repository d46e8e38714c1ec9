"""The five BASELINE.json benchmark configs on one GPU, one JSON line each.

1. LSKGE3: dense Gaussian sketch S@A of a tall data matrix (TLS shape)
2. RSKGE3 + submatrix views: A @ op(S) with a uniform DenseSkOp
3. LSKGES: SASO sketch of dense data, vec_nnz=8
4. Sketching sparse data: COO data with a dense operator (4), and the
   same data as BlockedELL (4b)
5. sketch_symmetric + sketch_vector + QB rangefinder pipeline

Every line names the device (platform, device_kind, count) and the card
with its power limit. Times are host-clock medians around
block_until_ready after warm-up (bench_util.time_host). Fails unless
JAX's default backend is a GPU.

Run: python benchmarks/run_all.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp

    import randblas_tpu as rb
    from randblas_tpu.bench_util import (device_info, nvidia_smi,
                                         require_gpu, time_host,
                                         use_compile_cache)
    from randblas_tpu.sparse_data import COOMatrix, ELLMatrix

    use_compile_cache()
    require_gpu()
    dev = {"device": device_info(), "card": nvidia_smi()}
    results = []

    def report(name, seconds, flops=None):
        rec = {"metric": name, "value": seconds, "unit": "s", **dev}
        if flops:
            rec["gflops"] = flops / seconds / 1e9
        results.append(rec)
        print(json.dumps(rec), flush=True)

    def normal(shape, seed, dtype=jnp.float32):
        return jax.random.normal(jax.random.key(seed), shape, dtype)

    # ---- config 1: LSKGE3 TLS shape, fp64 per BASELINE -------------------
    jax.config.update("jax_enable_x64", True)
    m, n = 100_000, 2_000
    d = 2 * (n + 1)
    A = normal((m, n), 0, jnp.float64)
    S1 = rb.DenseSkOp(rb.DenseDist(d, m), rb.RNGState.from_key(1),
                      dtype=jnp.float64)
    report("lskge3_tls_100kx2k_f64",
           time_host(lambda a: rb.sketch_general(S1, a), A),
           flops=2.0 * d * m * n)
    jax.config.update("jax_enable_x64", False)
    # f32 variant of the same shape
    A1f = A.astype(jnp.float32)
    del A
    S1f = rb.DenseSkOp(rb.DenseDist(d, m), rb.RNGState.from_key(1))
    report("lskge3_tls_100kx2k_f32",
           time_host(lambda a: rb.sketch_general(S1f, a), A1f),
           flops=2.0 * d * m * n)
    del A1f

    # ---- config 2: RSKGE3 + submatrix, uniform -------------------------
    rows, mm, dd = 16_384, 16_384, 1_024
    A2 = normal((rows, mm), 2)
    S2 = rb.DenseSkOp(rb.DenseDist(mm + 8, dd + 8, rb.DenseDistName.Uniform),
                      rb.RNGState.from_key(2))
    report("rskge3_submatrix_uniform",
           time_host(lambda a: rb.sketch_general(
               S2, a, side="right", d=dd, ro_s=8, co_s=8), A2),
           flops=2.0 * rows * mm * dd)
    del A2

    # ---- config 3: LSKGES SASO vec_nnz=8 --------------------------------
    m3, n3, d3 = 65_536, 2_048, 1_024
    A3 = normal((m3, n3), 3)
    S3 = rb.SparseSkOp(rb.SparseDist(d3, m3, vec_nnz=8),
                       rb.RNGState.from_key(3))
    report("lskges_saso_vecnnz8", time_host(lambda a: rb.sketch(S3, a), A3),
           flops=2.0 * 8 * m3 * n3)
    del A3

    # ---- config 4: sparse data SpMM with a dense operator ---------------
    m4, n4, d4 = 20_000, 10_000, 512
    rng = np.random.default_rng(4)
    nnz4 = (m4 * n4) // 200
    Asp = COOMatrix.from_arrays(m4, n4, rng.integers(0, m4, nnz4),
                                rng.integers(0, n4, nnz4),
                                rng.normal(size=nnz4).astype(np.float32))
    S4 = rb.DenseSkOp(rb.DenseDist(d4, m4), rb.RNGState.from_key(4))
    report("sketch_sparse_coo",
           time_host(lambda sp: rb.sketch_sparse(S4, sp), Asp),
           flops=2.0 * d4 * nnz4)
    # config 4b: the same data as word-major BlockedELL, sketched from
    # the right (the one-time format conversion is set-up, untimed)
    bell = ELLMatrix.from_coo(Asp).blocked(word_major=4)
    S4b = rb.DenseSkOp(rb.DenseDist(n4, d4), rb.RNGState.from_key(5))
    report("sketch_sparse_blocked_ell",
           time_host(lambda sp: rb.sketch_sparse(S4b, sp, side="right"),
                     bell),
           flops=2.0 * d4 * nnz4)

    # ---- config 5: wrappers + QB rangefinder pipeline -------------------
    nq, kq = 12_288, 256
    G = normal((nq, nq), 6)
    Aq = (G + G.T) * 0.5
    del G
    S5 = rb.DenseSkOp(rb.DenseDist(kq, nq), rb.RNGState.from_key(6))

    def pipeline(a):
        B = rb.sketch_symmetric(S5, a)                  # (k, n)
        y = rb.sketch_vector(S5, a[:, 0])               # (k,)
        q, _ = jnp.linalg.qr(B.T)                       # rangefinder step
        return q, y

    report("wrappers_qb_pipeline", time_host(pipeline, Aq))

    print(json.dumps({"suite": "baseline_configs", "results": len(results),
                      **dev}))


if __name__ == "__main__":
    main()
