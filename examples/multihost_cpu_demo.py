"""Multi-host sketching demo you can actually run on one machine.

Spawns TWO OS processes, each pretending to be a host with 2 devices
(virtual CPU backend), connects them with ``jax.distributed`` over a
localhost coordinator, builds the process-contiguous ('model', 'data')
mesh from ``make_multihost_sketch_mesh``, and runs one
``distributed_sketch`` whose psum crosses the process boundary through
XLA's gloo CPU collectives — the same program shape you would launch
one-per-host on a multi-host GPU cluster (see docs/distributed.md for
the launch recipe; the only changes there are ``num_processes`` /
``process_id`` coming from the scheduler and the backend being GPU).

Run: python examples/multihost_cpu_demo.py
"""

import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def worker(coord: str, pid: int, nproc: int) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    import randblas_tpu as rb
    from randblas_tpu.parallel import (
        distributed_sketch, initialize_multihost,
        make_multihost_sketch_mesh)

    # 1. join the cluster (on a pod: no arguments — env-discovered)
    initialize_multihost(coord, num_processes=nproc, process_id=pid)
    print(f"[proc {pid}] {len(jax.local_devices())} local devices, "
          f"{len(jax.devices())} global", flush=True)

    # 2. every process builds the SAME global mesh
    mesh = make_multihost_sketch_mesh(model=2)

    # 3. shard the data over the global 'data' axis (each process
    #    produces its own rows; here both generate the full array and
    #    make_array_from_callback picks each device's slice)
    d, m, n = 16, 64, 8
    a_np = np.random.default_rng(0).normal(size=(m, n)).astype(
        np.float32)
    A = jax.make_array_from_callback(
        (m, n), NamedSharding(mesh, P("data", None)),
        lambda idx: a_np[idx])

    # 4. one distributed sketch — the counter-addressed operator tiles
    #    are generated per device, the psum over 'data' rides gloo
    #    (DCN on a real pod), and the result is d-sharded over 'model'
    S = rb.DenseSkOp(rb.DenseDist(d, m), rb.RNGState.from_key(7))
    B = distributed_sketch(S, A, mesh)

    # 5. verify the locally addressable output shards bitwise-ish
    want = np.asarray(S.materialize()) @ a_np
    for shard in B.addressable_shards:
        np.testing.assert_allclose(np.asarray(shard.data),
                                    want[shard.index], rtol=2e-5,
                                    atol=1e-5)
    print(f"[proc {pid}] sketch verified against the single-device "
          f"oracle on {len(B.addressable_shards)} local shards",
          flush=True)


def main() -> None:
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}

    def run_once():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        coord = f"localhost:{port}"
        procs = [subprocess.Popen(
                     [sys.executable, os.path.abspath(__file__),
                      "--worker", coord, str(i), "2"], env=env)
                 for i in range(2)]
        try:
            return [p.wait(timeout=300) for p in procs]
        except subprocess.TimeoutExpired:
            for p in procs:          # never leak a gloo-holding orphan
                p.kill()
            return [1, 1]

    rc = run_once()
    if any(rc):
        # the probed port can be stolen before the coordinator binds
        # it (same race tests/test_multihost.py retries on)
        rc = run_once()
    if any(rc):
        raise SystemExit(f"worker exit codes: {rc}")
    print("both processes verified — see docs/distributed.md for the "
          "multi-host launch recipe")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    else:
        main()
