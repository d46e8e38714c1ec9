"""Headline benchmark: the dense Gaussian sketch against a plain GEMM on
one GPU (BASELINE.md shape: d=2^10, m=2^16, n=2^12, f32).

Prints exactly one JSON line:
  {"metric": ..., "value": <sketch GFLOP/s>, "unit": "GFLOP/s",
   "vs_baseline": <GEMM time / sketch time>, "device": {...},
   "card": "<name>, <power limit>", ...}

The sketch is ``sketch_general`` through its normal dispatch, operator
generated from counters. The baseline is ``jnp.matmul`` of the
pre-materialized operator with the same data at the same precision
(default f32: TF32 on the GPU), timed in the same process — the time the
sketch would take if generating the operator were free. Times are
host-clock medians around ``block_until_ready`` after warm-up, the two
sides alternated five times; vs_baseline is the median of the
per-alternation ratios. Fails unless JAX's default backend is a GPU.

Run: python bench.py
"""

import json

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    import randblas_tpu as rb
    from randblas_tpu.bench_util import (device_info, nvidia_smi,
                                         require_gpu, time_host,
                                         use_compile_cache)

    use_compile_cache()
    require_gpu()
    d, m, n = 1024, 65536, 4096
    flops = 2.0 * d * m * n
    S = rb.DenseSkOp(rb.DenseDist(d, m), rb.RNGState.from_key(0))
    A = jax.random.normal(jax.random.key(0), (m, n), jnp.float32)
    smat = rb.fill_dense(S.dist, S.seed_state)[0]

    def sketch(ctr, a):
        st = rb.RNGState.from_arrays(ctr, S.seed_state.key)
        return rb.sketch_general(rb.DenseSkOp(S.dist, st), a)

    ctr = S.seed_state.counter
    pairs = []
    for _ in range(5):
        t_gemm = time_host(jnp.matmul, smat, A)
        t_sketch = time_host(sketch, ctr, A)
        pairs.append((t_gemm, t_sketch))
    t_sketch = min(ts for _, ts in pairs)
    print(json.dumps({
        "metric": "dense_gaussian_sketch_gflops_d1024_m65536_n4096_f32",
        "value": flops / t_sketch / 1e9,
        "unit": "GFLOP/s",
        "vs_baseline": float(np.median([tg / ts for tg, ts in pairs])),
        "sketch_seconds": t_sketch,
        "gemm_seconds": min(tg for tg, _ in pairs),
        "device": device_info(),
        "card": nvidia_smi(),
    }))


if __name__ == "__main__":
    main()
