"""RNG fill micro-benchmark (counterpart of the reference's
test_basic_rng/benchmark_speed.cc: elapsed time to fill an m x n block).

Run: python benchmarks/rng_speed.py [m] [n] [gaussian|uniform]
Prints one JSON line with elapsed seconds (host clock around
block_until_ready, after warm-up), Gelem/s and the device. Fails unless
JAX's default backend is a GPU.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import randblas_tpu as rb
    from randblas_tpu.bench_util import (device_info, nvidia_smi,
                                         require_gpu, time_host,
                                         use_compile_cache)
    from randblas_tpu.dense import DenseDistName

    use_compile_cache()
    require_gpu()

    m = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 8192
    fam = (DenseDistName.Uniform if "uniform" in sys.argv[3:]
           else DenseDistName.Gaussian)
    dist = rb.DenseDist(m, n, fam)

    st = rb.RNGState.from_key(0)
    dt = time_host(lambda c: rb.fill_dense_submat(
        dist, rb.RNGState.from_arrays(c, st.key), m, n), st.counter)
    print(json.dumps({
        "metric": f"rng_fill_{fam.name.lower()}_{m}x{n}",
        "value": dt,
        "unit": "s",
        "gelem_per_s": m * n / dt / 1e9,
        "device": device_info(),
        "card": nvidia_smi(),
    }))


if __name__ == "__main__":
    main()
