"""Timings of the randomized-linalg tier on one GPU.

Times representative production pipelines end to end with the host
clock around block_until_ready after warm-up (bench_util.time_host):

  1. rsvd: rank-256 randomized SVD of a 32768 x 4096 f32 matrix
     (2 power iterations, p=8). Dominant cost ~ 6 * m*n*k flops.
  2. nystrom_pcg: regularized solve of an 8192^2 SPD system with a
     d=512 Nystrom preconditioner (the FTU21 kernel-ridge shape).
  3. ridge_lsq: 131072 x 2048 Blendenpik ridge solve, SASO embedding.
  4. sgmres: 8192^2 dense nonsymmetric solve, basis 80 (NT21 shape).
  5. sketched_eigs (sym=True, the jittable path): top-16 eigenpairs
     of an 8192^2 symmetric matrix, basis 64.
  6. rpcholesky_pcg: same SPD system as 2 with a rank-512 RPCholesky
     preconditioner (column sampling instead of a sketch pass).
  7. tensor_sketch / polynomial features: degree-3 features of
     4096-dim data, 2048 points, into d=4096.
  8. random_fourier_features: 65536 points x 128 dims -> 4096 RBF
     features (one fused sketch + phase map).
  9. rand_geigh: k=32 pairs of an 8192^2 symmetric-definite pencil
     (implicit Cholesky-whitened rangefinder).

Run: python benchmarks/linalg_bench.py [names...]  (no names = all).
Fails unless JAX's default backend is a GPU; the first line names the
device and the card with its power limit.
"""

import sys
import numpy as np

sys.path.insert(0, ".")

import jax                                                      # noqa: E402
import jax.numpy as jnp                                         # noqa: E402


from randblas_tpu import RNGState                               # noqa: E402
from randblas_tpu.bench_util import (                           # noqa: E402
    device_info, nvidia_smi, require_gpu, time_host, use_compile_cache,
)
from randblas_tpu.linalg import (                               # noqa: E402
    nystrom_pcg, random_fourier_features, ridge_lsq, rpcholesky_pcg,
    rsvd, sgmres, sketched_eigs,
)  # rand_geigh imported lazily in its bench body
from randblas_tpu.tensor import polynomial_kernel_features      # noqa: E402


def time_call(body, *operands, **_):
    """Seconds per call of ``body(0, 0.0, *operands)`` on the host clock
    (the bodies below thread an (i, carry) pair that a single call does
    not need)."""
    return time_host(lambda *ops: body(jnp.int32(0), jnp.float32(0.0),
                                       *ops), *operands)


def bench_rsvd():
    m, n, rank = 32768, 4096, 256
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.normal(size=(m, n)).astype(np.float32))

    def body(i, carry, a_op):
        # data dependence on (i, carry) so iterations can't be elided
        u, s, vt = rsvd(a_op + carry * 0.0, rank,
                        RNGState.from_key(7), power_iters=2)
        return carry + s[0] * 1e-20 + jnp.float32(i) * 0.0

    t = time_call(body, a, iters_small=1, iters_large=4, repeats=2)
    k = rank + 8
    flops = 6 * m * n * k            # sketch + 2 power iters + B
    print(f"rsvd {m}x{n} rank {rank}: {t*1e3:.1f} ms/solve "
          f"(~{flops/t/1e12:.1f} TFLOP/s on the dominant products)")


def bench_nystrom_pcg():
    n, d = 8192, 512
    rng = np.random.default_rng(1)
    g = rng.normal(size=(n, 64)).astype(np.float32) / 8.0
    a = jnp.asarray(g @ g.T + 0.1 * np.eye(n, dtype=np.float32))
    b = jnp.asarray(rng.normal(size=n).astype(np.float32))

    def body(i, carry, a_op, b_op):
        x, iters, _ = nystrom_pcg(a_op, b_op + carry * 0.0,
                                  RNGState.from_key(8), d=d, mu=1e-3,
                                  tol=1e-5, maxiter=60)
        return carry + x[0] * 1e-20 + jnp.float32(i) * 0.0

    t = time_call(body, a, b, iters_small=1, iters_large=3, repeats=2)
    print(f"nystrom_pcg n={n}, d={d}: {t*1e3:.1f} ms/solve")


def bench_ridge():
    m, n = 131072, 2048
    rng = np.random.default_rng(2)
    a = jnp.asarray(rng.normal(size=(m, n)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=m).astype(np.float32))

    def body(i, carry, a_op, b_op):
        x, iters, _ = ridge_lsq(a_op, b_op + carry * 0.0, 1e-2,
                                RNGState.from_key(9), tol=1e-5,
                                maxiter=40)
        return carry + x[0] * 1e-20 + jnp.float32(i) * 0.0

    t = time_call(body, a, b, iters_small=1, iters_large=3, repeats=2)
    print(f"ridge_lsq {m}x{n}: {t*1e3:.1f} ms/solve")


def bench_sgmres():
    n, basis = 8192, 80
    rng = np.random.default_rng(3)
    a = jnp.asarray((rng.normal(size=(n, n)) / np.sqrt(n)
                     + 4 * np.eye(n)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=n).astype(np.float32))

    def body(i, carry, a_op, b_op):
        x, res, _ = sgmres(a_op, b_op + carry * 0.0,
                           RNGState.from_key(10), basis=basis)
        return carry + x[0] * 1e-20 + jnp.float32(i) * 0.0

    t = time_call(body, a, b, iters_small=1, iters_large=3, repeats=2)
    # dominant cost: basis SEQUENTIAL dense matvecs — bandwidth-bound
    # (each reads the n^2 f32 matrix once), so report effective GB/s
    # against the ~800 GB/s HBM roofline.
    gbytes = basis * n * n * 4 / 1e9
    print(f"sgmres n={n}, basis={basis}: {t*1e3:.1f} ms/solve "
          f"(~{gbytes/t:.0f} GB/s on the matvec reads)")


def bench_sketched_eigs():
    n, k, basis = 8192, 16, 64
    rng = np.random.default_rng(4)
    g = rng.normal(size=(n, n)).astype(np.float32)
    a = jnp.asarray((g + g.T) / np.sqrt(2 * n))

    def body(i, carry, a_op):
        theta, x, resid, _ = sketched_eigs(a_op + carry * 0.0, k,
                                           RNGState.from_key(11),
                                           basis=basis, sym=True)
        return carry + theta[0] * 1e-20 + jnp.float32(i) * 0.0

    t = time_call(body, a, iters_small=1, iters_large=3, repeats=2)
    gbytes = basis * n * n * 4 / 1e9
    print(f"sketched_eigs(sym) n={n}, k={k}, basis={basis}: "
          f"{t*1e3:.1f} ms/solve "
          f"(~{gbytes/t:.0f} GB/s on the matvec reads)")


def bench_rpcholesky_pcg():
    n, rank = 8192, 512
    rng = np.random.default_rng(5)
    g = rng.normal(size=(n, 64)).astype(np.float32) / 8.0
    a = jnp.asarray(g @ g.T + 0.1 * np.eye(n, dtype=np.float32))
    b = jnp.asarray(rng.normal(size=n).astype(np.float32))

    def body(i, carry, a_op, b_op):
        x, iters, _ = rpcholesky_pcg(a_op, b_op + carry * 0.0,
                                     RNGState.from_key(12), rank=rank,
                                     mu=1e-3, tol=1e-5, maxiter=60)
        return carry + x[0] * 1e-20 + jnp.float32(i) * 0.0

    t = time_call(body, a, b, iters_small=1, iters_large=3, repeats=2)
    print(f"rpcholesky_pcg n={n}, rank={rank}: {t*1e3:.1f} ms/solve")


def bench_tensor_sketch():
    m, n, d, degree = 4096, 2048, 4096, 3
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.normal(size=(m, n)).astype(np.float32)
                    / np.sqrt(m))

    def body(i, carry, x_op):
        z, _ = polynomial_kernel_features(x_op + carry * 0.0, degree, d,
                                          RNGState.from_key(13))
        return carry + z[0, 0] * 1e-20 + jnp.float32(i) * 0.0

    t = time_call(body, x, iters_small=2, iters_large=8, repeats=2)
    # implicit product has m^degree rows; report throughput on the work
    # actually done: degree CountSketches (nnz pass over x) + FFT mults
    elems = degree * m * n + degree * d * n
    print(f"tensor_sketch degree={degree}, {m}x{n} -> d={d}: "
          f"{t*1e3:.2f} ms/transform ({elems/t/1e9:.1f} Gelem/s; "
          f"implicit row count m^p = {m**degree:.2e})")


def bench_rand_geigh():
    n, k = 8192, 32
    rng = np.random.default_rng(8)
    g = rng.normal(size=(n, n)).astype(np.float32)
    a = jnp.asarray((g + g.T) / np.sqrt(2 * n))
    h = rng.normal(size=(n, 64)).astype(np.float32) / 8.0
    b = jnp.asarray(h @ h.T + np.eye(n, dtype=np.float32))

    def body(i, carry, a_op, b_op):
        from randblas_tpu.linalg import rand_geigh
        w, x = rand_geigh(a_op + carry * 0.0, b_op, k,
                          RNGState.from_key(15))
        return carry + w[0] * 1e-20 + jnp.float32(i) * 0.0

    t = time_call(body, a, b, iters_small=1, iters_large=3, repeats=2)
    # the whitened operator is implicit: 6 applies of
    # C X = L^-1 (A (L^-T X)) at O(n^2 k) each instead of forming C
    # with two n-RHS triangular solves; per apply: A-apply 2*n^2*k + two k-RHS triangular solves at
    # n^2*k each (n^2/2 multiply-adds per RHS)
    flops = 6 * (2 * n * n * k + 2 * n * n * k)
    print(f"rand_geigh n={n}, k={k}: {t*1e3:.1f} ms/solve "
          f"(~{flops/t/1e12:.1f} TFLOP/s on the implicit whitened "
          "applies; explicit whitening: 74.4 ms)")


def bench_amm():
    m, n, p, s = 2048, 262144, 2048, 16384
    rng = np.random.default_rng(9)
    a = jnp.asarray(rng.normal(size=(m, n)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=(n, p)).astype(np.float32))

    def body(i, carry, a_op, b_op):
        from randblas_tpu.linalg import amm
        est, _ = amm(a_op + carry * 0.0, b_op, s, RNGState.from_key(16))
        return carry + est[0, 0] * 1e-20 + jnp.float32(i) * 0.0

    t = time_call(body, a, b, iters_small=1, iters_large=4, repeats=2)
    exact_flops = 2.0 * m * n * p
    done_flops = 2.0 * m * s * p + 2 * (m + p) * n
    print(f"amm {m}x{n} @ {n}x{p}, s={s} ({s/n:.1%} of n): "
          f"{t*1e3:.1f} ms/estimate — {done_flops/t/1e12:.1f} TFLOP/s "
          f"on the sampled GEMM, {exact_flops/done_flops:.0f}x less "
          "work than the exact product")


def bench_sample_lsq():
    m, n, s = 524288, 512, 8192
    rng = np.random.default_rng(10)
    a = jnp.asarray(rng.normal(size=(m, n)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=m).astype(np.float32))

    def body(i, carry, a_op, b_op):
        from randblas_tpu.linalg import sample_lsq
        x, _ = sample_lsq(a_op, b_op + carry * 0.0, s,
                          RNGState.from_key(17))
        return carry + x[0] * 1e-20 + jnp.float32(i) * 0.0

    t = time_call(body, a, b, iters_small=1, iters_large=3, repeats=2)
    print(f"sample_lsq {m}x{n}, s={s} ({s/m:.1%} of rows): "
          f"{t*1e3:.1f} ms/solve (leverage estimation pass + row "
          "gather + damped-QR subproblem)")


def bench_rff():
    n, dim, feat = 65536, 128, 4096
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.normal(size=(n, dim)).astype(np.float32))

    def body(i, carry, x_op):
        z, _ = random_fourier_features(x_op + carry * 0.0, feat, 1.0,
                                       RNGState.from_key(14))
        return carry + z[0, 0] * 1e-20 + jnp.float32(i) * 0.0

    t = time_call(body, x, iters_small=2, iters_large=8, repeats=2)
    flops = 2 * n * dim * feat
    print(f"random_fourier_features {n}x{dim} -> {feat}: "
          f"{t*1e3:.2f} ms/map (~{flops/t/1e12:.1f} TFLOP/s on the "
          "projection)")


def bench_xtrace():
    # implicit PSD operator at 16384^2: xtrace never forms A, only
    # (n, m) block products — the production shape for trace of a
    # Gram/kernel matrix. 64-matvec budget (m=32 probe columns).
    n, k, budget = 16384, 256, 64
    rng = np.random.default_rng(9)
    g = jnp.asarray(rng.normal(size=(n, k)).astype(np.float32)
                    / np.sqrt(k))

    def body(i, carry, g_op):
        from randblas_tpu.linalg import xtrace
        gg = g_op + carry * 0.0                  # loop-carried dependence
        mv = lambda x: gg @ (gg.T @ x)           # noqa: E731
        est, se, _ = xtrace(mv, n, budget, RNGState.from_key(13))
        return carry + est * 1e-20 + se * 0.0 + jnp.float32(i) * 0.0

    t = time_call(body, g, iters_small=1, iters_large=4, repeats=2)
    flops = 2 * budget * 2 * n * k               # Y and Z block products
    print(f"xtrace n={n} (implicit Gram, rank {k}), budget {budget}: "
          f"{t*1e3:.2f} ms/estimate (~{flops/t/1e9:.0f} GFLOP/s matvecs)")


def bench_xdiag():
    n, k, budget = 16384, 256, 64
    rng = np.random.default_rng(10)
    g = jnp.asarray(rng.normal(size=(n, k)).astype(np.float32)
                    / np.sqrt(k))

    def body(i, carry, g_op):
        from randblas_tpu.linalg import xdiag
        gg = g_op + carry * 0.0                  # loop-carried dependence
        mv = lambda x: gg @ (gg.T @ x)           # noqa: E731, symmetric
        d, _ = xdiag(mv, n, budget, RNGState.from_key(14))
        return carry + d[0] * 1e-20 + jnp.float32(i) * 0.0

    t = time_call(body, g, iters_small=1, iters_large=4, repeats=2)
    flops = 2 * budget * 2 * n * k
    print(f"xdiag n={n} (implicit Gram, rank {k}), budget {budget}: "
          f"{t*1e3:.2f} ms/estimate (~{flops/t/1e9:.0f} GFLOP/s matvecs)")


def bench_kaczmarz():
    # restricted-access solvers at a production shape: each step reads
    # one (block, n) row panel / (m, block) column panel
    m, n, block, steps = 65536, 1024, 512, 48
    rng = np.random.default_rng(11)
    a = jnp.asarray(rng.standard_normal((m, n)).astype(np.float32))
    xt = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    b = a @ xt

    def body(i, carry, a_op, b_op):
        from randblas_tpu.linalg import block_kaczmarz
        x, _ = block_kaczmarz(a_op, b_op + carry * 0.0,
                              RNGState.from_key(15), block=block,
                              steps=steps)
        return carry + x[0] * 1e-20 + jnp.float32(i) * 0.0

    t = time_call(body, a, b, iters_small=1, iters_large=3, repeats=2)
    gbytes = steps * block * n * 4 / 1e9      # row-panel gathers
    print(f"block_kaczmarz {m}x{n}, block {block}, {steps} steps: "
          f"{t*1e3:.1f} ms/solve (~{gbytes/t:.0f} GB/s on panel reads)")

    for mode in ("shuffle", "colnorm"):
        def body_gs(i, carry, a_op, b_op):
            from randblas_tpu.linalg import block_gauss_seidel
            x, _ = block_gauss_seidel(a_op, b_op + carry * 0.0,
                                      RNGState.from_key(16),
                                      block=block, steps=steps,
                                      sampling=mode)
            return carry + x[0] * 1e-20 + jnp.float32(i) * 0.0

        t = time_call(body_gs, a, b, iters_small=1, iters_large=3,
                      repeats=2)
        gbytes = steps * m * block * 4 / 1e9  # column-panel reads (x3)
        print(f"block_gauss_seidel[{mode}] {m}x{n}, block {block}, "
              f"{steps} steps: {t*1e3:.1f} ms/solve "
              f"(~{3*gbytes/t:.0f} GB/s on panel traffic)")


def bench_fd():
    # FrequentDirections is host-DRIVEN streaming (chunk arrival is a
    # host decision): measure wall time around the whole ingest with a
    # final host transfer of the sketch. The numbers include Python
    # dispatch overhead — honest for this API.
    import time
    from randblas_tpu.linalg import FrequentDirections
    m, n, ell, chunk = 65536, 1024, 256, 4096
    rng = np.random.default_rng(12)
    blocks = [jnp.asarray(rng.standard_normal((chunk, n))
                          .astype(np.float32)) for _ in range(m // chunk)]
    for b in blocks:
        b.block_until_ready()

    def run():
        fd = FrequentDirections(n, ell)
        for b in blocks:
            fd.update(b)
        return np.asarray(fd.sketch())

    run()                                    # compile the shrink SVD
    t0 = time.perf_counter()
    run()
    t = time.perf_counter() - t0
    print(f"frequent_directions {m}x{n} rows, ell={ell}, "
          f"chunk {chunk}: {t*1e3:.0f} ms/stream "
          f"({m/t/1e6:.2f} Mrows/s, {m*n*4/t/1e9:.0f} GB/s ingest; "
          f"{m//ell - 1} shrink SVDs of (512, {n}))")

    # one-dispatch ingest of a device-resident matrix: same
    # math, no per-chunk host round trips
    a_full = jnp.concatenate(blocks, axis=0)
    a_full.block_until_ready()

    def run_ingest():
        fd = FrequentDirections(n, ell)
        fd.ingest(a_full)
        return np.asarray(fd.sketch())

    run_ingest()
    t0 = time.perf_counter()
    run_ingest()
    t = time.perf_counter() - t0
    print(f"frequent_directions.ingest same stream: {t*1e3:.0f} ms "
          f"({m/t/1e6:.2f} Mrows/s, {m*n*4/t/1e9:.0f} GB/s)")


def bench_density():
    # DOS of an implicit operator: the shape where densities matter
    # (spectrum exploration before committing a rank/shift budget)
    n, k = 16384, 256
    rng = np.random.default_rng(13)
    g = jnp.asarray(rng.normal(size=(n, k)).astype(np.float32)
                    / np.sqrt(k))
    grid = jnp.linspace(-0.5, 8.0, 401)

    def body_slq(i, carry, g_op):
        from randblas_tpu.linalg import spectral_density
        gg = g_op + carry * 0.0
        mv = lambda x: gg @ (gg.T @ x)           # noqa: E731
        _, dens, _ = spectral_density(mv, RNGState.from_key(17),
                                      probes=16, steps=60, grid=grid,
                                      sigma=0.05, n=n)
        return carry + dens[0] * 1e-20 + jnp.float32(i) * 0.0

    t = time_call(body_slq, g, iters_small=1, iters_large=3, repeats=2)
    print(f"spectral_density[slq] n={n} implicit Gram, 16 probes x 60 "
          f"steps: {t*1e3:.1f} ms/estimate")

    def body_kpm(i, carry, g_op):
        from randblas_tpu.linalg import kpm_density
        gg = g_op + carry * 0.0
        mv = lambda x: gg @ (gg.T @ x)           # noqa: E731
        _, dens, _ = kpm_density(mv, RNGState.from_key(18), probes=16,
                                 degree=128, bounds=(-0.5, 8.0),
                                 grid=grid, n=n)
        return carry + dens[0] * 1e-20 + jnp.float32(i) * 0.0

    t = time_call(body_kpm, g, iters_small=1, iters_large=3, repeats=2)
    flops = 16 * 128 * 2 * 2 * n * k
    print(f"kpm_density n={n} implicit Gram, 16 probes x degree 128: "
          f"{t*1e3:.1f} ms/estimate (~{flops/t/1e12:.1f} TFLOP/s on "
          f"the Chebyshev matvecs)")


def bench_rgs():
    # the stability QR at a production rangefinder shape; compare the
    # fast-path CholQR2 (well-conditioned regime) in the same run
    m, k = 65536, 512
    rng = np.random.default_rng(14)
    a = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))

    def body(i, carry, a_op):
        from randblas_tpu.linalg.rgs import rgs_qr
        q, r, _ = rgs_qr(a_op + carry * 0.0, RNGState.from_key(19),
                         block=128)
        return carry + q[0, 0] * 1e-20 + r[0, 0] * 1e-20 \
            + jnp.float32(i) * 0.0

    t = time_call(body, a, iters_small=1, iters_large=3, repeats=2)
    flops = 2 * 2 * m * k * k          # two full-length GEMM passes
    print(f"rgs_qr {m}x{k} (block 128): {t*1e3:.1f} ms "
          f"(~{flops/t/1e12:.1f} TFLOP/s on the projection GEMMs)")

    def body_chol(i, carry, a_op):
        from randblas_tpu.linalg import cholqr
        q, r = cholqr(a_op + carry * 0.0)
        return carry + q[0, 0] * 1e-20 + r[0, 0] * 1e-20 \
            + jnp.float32(i) * 0.0

    t = time_call(body_chol, a, iters_small=1, iters_large=3, repeats=2)
    print(f"cholqr2 {m}x{k} (same run): {t*1e3:.1f} ms")


def bench_tt():
    # TT rounding: a rank-128 4-mode TT (the doubled output of a
    # rank-64 tt_add) rounded back to 64. The hot work is the right
    # interface chain (batched einsums) and the per-mode (r n, r)
    # panel QRs. (A 5-mode rank-256 variant's graph of chained
    # (16k, 264) QRs + SVDs takes far longer to compile.)
    from randblas_tpu.linalg import tt_add, tt_gaussian, tt_round
    shape, r_in, r_out = (64,) * 4, 64, 64
    x, _ = tt_gaussian(shape, r_in, RNGState.from_key(20))
    s = tt_add(x, x)                     # ranks 256

    def body(i, carry, *cores):
        from randblas_tpu.linalg import TTTensor
        cs = list(cores)
        cs[0] = cs[0] + carry * 0.0
        r, _ = tt_round(TTTensor(cs), r_out, RNGState.from_key(21),
                        oversample=8)
        return carry + r.cores[0][0, 0, 0] * 1e-20 + jnp.float32(i) * 0.0

    t = time_call(body, *s.cores, iters_small=1, iters_large=8,
                  repeats=2)
    print(f"tt_round {shape} ranks {2 * r_in}->{r_out}: "
          f"{t*1e3:.3f} ms")

    def body_fd(i, carry, dense):
        from randblas_tpu.linalg import tt_from_dense
        tt, _ = tt_from_dense(dense + carry * 0.0, 64,
                              RNGState.from_key(22), power_iters=1)
        return carry + tt.cores[0][0, 0, 0] * 1e-20 + jnp.float32(i) * 0.0

    dense = jnp.asarray(np.random.default_rng(23).standard_normal(
        (64, 64, 64, 64)).astype(np.float32))
    t = time_call(body_fd, dense, iters_small=1, iters_large=3,
                  repeats=2)
    print(f"tt_from_dense 64^4 ranks 64: {t*1e3:.1f} ms")

    def body_tk(i, carry, d_op):
        from randblas_tpu.linalg import tucker_from_dense
        c, f, _ = tucker_from_dense(d_op + carry * 0.0, 32,
                                    RNGState.from_key(26),
                                    power_iters=1)
        return carry + c[0, 0, 0, 0] * 1e-20 + jnp.float32(i) * 0.0

    t = time_call(body_tk, dense, iters_small=1, iters_large=3,
                  repeats=2)
    print(f"tucker_from_dense 64^4 ranks 32 (same run): {t*1e3:.1f} ms")


def bench_kfjlt():
    # Khatri-Rao embedding of two 65536-row factors into d=1024: per-
    # mode Hadamard (the SRHT stages) + row gathers + one product.
    from randblas_tpu.tensor import kfjlt_sketch, tensor_sketch
    m, n, d = 65536, 64, 1024
    rng = np.random.default_rng(24)
    mats = [jnp.asarray(rng.standard_normal((m, n)).astype(np.float32))
            for _ in range(2)]

    def body(i, carry, a1, a2):
        out, _ = kfjlt_sketch([a1 + carry * 0.0, a2], d,
                              RNGState.from_key(25))
        return carry + out[0, 0] * 1e-20 + jnp.float32(i) * 0.0

    t = time_call(body, *mats, iters_small=1, iters_large=8, repeats=2)
    print(f"kfjlt_sketch 2x({m}x{n}) -> d={d}: {t*1e3:.3f} ms")

    def body_ts(i, carry, a1, a2):
        out, _ = tensor_sketch([a1 + carry * 0.0, a2], d,
                               RNGState.from_key(25))
        return carry + out[0, 0] * 1e-20 + jnp.float32(i) * 0.0

    t = time_call(body_ts, *mats, iters_small=1, iters_large=8,
                  repeats=2)
    print(f"tensor_sketch same shape (same run): {t*1e3:.3f} ms")


def bench_ihs():
    # same shape as bench_ridge so the two solver-accurate LS routes
    # are directly comparable: one SASO sketch + 24 heavy-ball steps
    # (deterministic 0.5^24 contraction) vs sketch-QR + CGLS
    m, n = 131072, 2048
    rng = np.random.default_rng(26)
    a = jnp.asarray(rng.normal(size=(m, n)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=m).astype(np.float32))
    from randblas_tpu.linalg import ihs_lsq

    def body(i, carry, a_op, b_op):
        x, _ = ihs_lsq(a_op, b_op + carry * 0.0, RNGState.from_key(27),
                       iters=24)
        return carry + x[0] * 1e-20 + jnp.float32(i) * 0.0

    t = time_call(body, a, b, iters_small=1, iters_large=3, repeats=2)
    print(f"ihs_lsq {m}x{n} d=4n, 24 iters: {t*1e3:.1f} ms/solve")


BENCHES = {
    "rsvd": bench_rsvd,
    "nystrom": bench_nystrom_pcg,
    "ridge": bench_ridge,
    "sgmres": bench_sgmres,
    "eigs": bench_sketched_eigs,
    "rpcholesky": bench_rpcholesky_pcg,
    "tensor": bench_tensor_sketch,
    "rff": bench_rff,
    "geigh": bench_rand_geigh,
    "amm": bench_amm,
    "samplelsq": bench_sample_lsq,
    "xtrace": bench_xtrace,
    "xdiag": bench_xdiag,
    "kaczmarz": bench_kaczmarz,
    "fd": bench_fd,
    "density": bench_density,
    "rgs": bench_rgs,
    "tt": bench_tt,
    "kfjlt": bench_kfjlt,
    "ihs": bench_ihs,
}


if __name__ == "__main__":
    use_compile_cache()
    require_gpu()
    print(f"device: {device_info()}, card: {nvidia_smi()}")
    names = sys.argv[1:] or list(BENCHES)
    for name in names:
        BENCHES[name]()
