"""Sketch-and-precondition least squares (Blendenpik/LSRN-style).

The other classic RandNLA workload next to sketch-and-solve
(examples/total_least_squares.py, the reference's TLS examples): for a
tall overdetermined min ||A x - b||, sketch A down to d ~ 2n rows with a
SASO, take the QR of the sketch, and use its R factor as a RIGHT
preconditioner for an iterative solver on the FULL problem. The sketch
guarantees cond(A R^-1) = O(1) with high probability, so CGLS/LSQR
converges in a few dozen iterations independent of cond(A) — and the
answer is exact to solver tolerance (unlike sketch-and-solve, which is
only delta-accurate).

Everything runs in-graph: the SASO is sampled by the in-graph
Fisher-Yates (sparse.py), the sketch is one fused/one-hot product, and
CGLS is a lax.while_loop. Run: python examples/sketch_precondition_lsq.py
"""

import sys
import time

sys.path.insert(0, ".")

import jax                                                       # noqa: E402
import jax.numpy as jnp                                          # noqa: E402
import numpy as np                                               # noqa: E402

from randblas_tpu import RNGState                                # noqa: E402
from randblas_tpu.linalg import (                                # noqa: E402
    cgls, ihs_lsq, sketch_and_precondition,
)


def solve_preconditioned(A, b, seed=0, vec_nnz=8, d=None):
    """min ||A x - b|| via SASO sketch -> QR -> right-preconditioned CGLS
    (library call: randblas_tpu.linalg.sketch_and_precondition).

    Returns (x, cgls_iterations)."""
    x, iters, _ = sketch_and_precondition(
        A, b, RNGState.from_key(seed), d=d, vec_nnz=vec_nnz, tol=1e-12,
        maxiter=200)
    return x, iters


def main():
    # f64 throughout: with cond(A) ~ 1e8, the R^-1 amplification sits at
    # the f32 noise floor — preconditioned iterations are an f64 method
    jax.config.update("jax_enable_x64", True)
    m, n = 20000, 400
    cond_target = 1e8
    rng = np.random.default_rng(0)
    # build A with controlled condition number
    u, _ = np.linalg.qr(rng.normal(size=(m, n)))
    v, _ = np.linalg.qr(rng.normal(size=(n, n)))
    sv = np.logspace(0, -np.log10(cond_target), n)
    A = jnp.asarray((u * sv) @ v.T, jnp.float64)
    x_true = jnp.asarray(rng.normal(size=(n,)), jnp.float64)
    b = A @ x_true + 1e-6 * jnp.asarray(rng.normal(size=(m,)), jnp.float64)

    solver = jax.jit(solve_preconditioned)
    x, iters = solver(A, b)
    jax.block_until_ready(x)
    t0 = time.perf_counter()
    x, iters = solver(A, b)
    jax.block_until_ready(x)
    t_pre = time.perf_counter() - t0

    # unpreconditioned CGLS for comparison (same tolerance, same budget)
    plain = jax.jit(lambda A, b: cgls(lambda y: A @ y,
                                      lambda r: A.T @ r, b, n))
    x_plain, iters_plain, _ = plain(A, b)
    jax.block_until_ready(x_plain)

    # iterative Hessian sketch with heavy-ball momentum: the Krylov-free
    # alternative — one sketch, a FIXED number of damped Newton steps at
    # the deterministic sqrt(n/d) rate (no convergence monitoring)
    ihs = jax.jit(lambda A, b: ihs_lsq(A, b, RNGState.from_key(1),
                                       iters=40)[0])
    x_ihs = ihs(A, b)
    jax.block_until_ready(x_ihs)
    t0 = time.perf_counter()
    x_ihs = ihs(A, b)
    jax.block_until_ready(x_ihs)
    t_ihs = time.perf_counter() - t0

    res = float(jnp.linalg.norm(A @ x - b))
    res_plain = float(jnp.linalg.norm(A @ x_plain - b))
    res_true = float(jnp.linalg.norm(A @ x_true - b))
    print(f"cond(A) ~ {cond_target:.0e}, shape {m}x{n}")
    print(f"preconditioned CGLS:   {int(iters):4d} iters, "
          f"residual {res:.3e}  ({t_pre*1e3:.1f} ms/solve)")
    print(f"plain CGLS:            {int(iters_plain):4d} iters, "
          f"residual {res_plain:.3e}")
    res_ihs = float(jnp.linalg.norm(A @ x_ihs - b))
    print(f"IHS heavy-ball:          40 steps, "
          f"residual {res_ihs:.3e}  ({t_ihs*1e3:.1f} ms/solve)")
    print(f"ground-truth residual: {res_true:.3e}")


if __name__ == "__main__":
    main()
