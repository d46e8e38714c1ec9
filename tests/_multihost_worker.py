"""Worker program for the LIVE multi-process test (test_multihost.py::
test_live_two_process_distributed_sketch). Not collected by pytest.

Each process: 2 virtual CPU devices, jax.distributed over a localhost
coordinator (XLA's gloo CPU collectives — the same cross-process
collective machinery a multi-host cluster uses, modulo transport),
a process-contiguous ('model','data') mesh from
make_multihost_sketch_mesh, one distributed_sketch, oracle check of the
locally addressable output shards.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> None:
    coord, pid_s, nproc_s = sys.argv[1], sys.argv[2], sys.argv[3]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax

    jax.config.update("jax_platforms", "cpu")
    from randblas_tpu.parallel import (
        initialize_multihost, make_multihost_sketch_mesh,
        distributed_sketch)

    initialize_multihost(coord, num_processes=int(nproc_s),
                         process_id=int(pid_s))

    import numpy as np
    import jax.numpy as jnp  # noqa: F401
    from jax.sharding import NamedSharding, PartitionSpec as P
    import randblas_tpu as rb

    n_procs = int(nproc_s)
    assert len(jax.devices()) == 2 * n_procs, "global device view"
    assert len(jax.local_devices()) == 2, "local device view"

    mesh = make_multihost_sketch_mesh(model=2)
    assert mesh.devices.shape == (2, n_procs)
    for col in range(mesh.devices.shape[1]):
        owners = {d.process_index for d in mesh.devices[:, col].ravel()}
        assert len(owners) == 1, \
            f"'model' crossed a process boundary in data column {col}"

    # one aligned (m-sharded input) and one pad-and-shard (m not
    # divisible; replicated input — distributed_sketch pads and
    # shard_map reshards) case
    for d, m, spec in ((16, 32, P("data", None)), (12, 23, P())):
        n = 8
        S = rb.DenseSkOp(rb.DenseDist(d, m), rb.RNGState.from_key(7))
        a_np = np.random.default_rng(0).normal(size=(m, n)).astype(
            np.float32)
        sh = NamedSharding(mesh, spec)
        A = jax.make_array_from_callback((m, n), sh,
                                         lambda idx: a_np[idx])
        B = distributed_sketch(S, A, mesh)
        want = np.asarray(S.materialize()) @ a_np
        for shard in B.addressable_shards:
            np.testing.assert_allclose(np.asarray(shard.data),
                                       want[shard.index], rtol=2e-5,
                                       atol=1e-5)
    print(f"proc {pid_s}: OK", flush=True)


if __name__ == "__main__":
    main()
