"""Multi-chip sketching demo: one global operator, zero-communication
generation, psum-only contraction.

Needs two or more devices: several GPUs, or on the CPU a virtual 8-device
mesh (set here through XLA_FLAGS when it is not already set).
Shows: mesh-shape invariance of the generated operator, the sharded
sketch, and a distributed rangefinder step.

Run: python examples/distributed_sketching.py
"""

import os
import sys

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")
sys.path.insert(0, ".")

import jax                                                       # noqa: E402

if len(jax.devices()) < 2:
    raise SystemExit(
        f"needs two or more devices, found {len(jax.devices())} "
        f"({jax.default_backend()}); on the CPU run with "
        "XLA_FLAGS=--xla_force_host_platform_device_count=8")

import jax.numpy as jnp                                          # noqa: E402
import numpy as np                                               # noqa: E402

from randblas_tpu import DenseDist, DenseSkOp, RNGState, \
    sketch_general                                               # noqa: E402
from randblas_tpu.parallel import distributed_sketch, \
    make_sketch_mesh                                             # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P       # noqa: E402


def main():
    n_dev = len(jax.devices())
    print(f"devices: {n_dev} x {jax.devices()[0].platform}")
    d, m, n = 32, 1024, 64
    S = DenseSkOp(DenseDist(d, m), RNGState.from_key(42))
    A = jnp.asarray(
        np.random.default_rng(0).normal(size=(m, n)).astype(np.float32))

    reference = np.asarray(sketch_general(S, A))

    for model in (1, 2):
        data = n_dev // model
        if model * data != n_dev or d % model or m % data:
            continue
        mesh = make_sketch_mesh(model, data)
        A_sharded = jax.device_put(A, NamedSharding(mesh, P("data", None)))
        B = distributed_sketch(S, A_sharded, mesh)
        err = float(np.abs(np.asarray(B) - reference).max())
        print(f"mesh {model}x{data}: B {B.shape} sharded "
              f"{B.sharding.spec}, max |diff| vs single-device = {err:.2e}")

    # distributed rangefinder step: sketch then orthonormalize
    mesh = make_sketch_mesh(1, n_dev)
    A_sharded = jax.device_put(A, NamedSharding(mesh, P("data", None)))
    B = distributed_sketch(S, A_sharded, mesh)
    q, _ = jnp.linalg.qr(B.T)
    print(f"rangefinder Q: {q.shape}, orthonormality error "
          f"{float(jnp.abs(q.T @ q - jnp.eye(q.shape[1])).max()):.2e}")

    # full distributed randomized SVD: the m-sized factors stay sharded
    # end to end (CholQR Gram psums are the only collectives)
    from randblas_tpu.linalg import distributed_rsvd
    rng = np.random.default_rng(1)
    r = 6
    u0, _ = np.linalg.qr(rng.normal(size=(m, r)))
    v0, _ = np.linalg.qr(rng.normal(size=(n, r)))
    s_true = np.linspace(5.0, 1.0, r)
    M = jnp.asarray((u0 * s_true) @ v0.T, jnp.float32)
    M = jax.device_put(M, NamedSharding(mesh, P("data", None)))
    U, s_hat, Vt = distributed_rsvd(M, r, RNGState.from_key(7), mesh)
    print(f"distributed_rsvd: U {U.shape} sharded {U.sharding.spec}, "
          f"singular-value error "
          f"{float(np.abs(np.asarray(s_hat) - s_true).max()):.2e}")


if __name__ == "__main__":
    main()
