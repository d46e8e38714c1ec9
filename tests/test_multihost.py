"""Multi-host mesh construction (parallel/multihost.py).

No multi-host hardware exists in CI; the arrangement logic is pure and
exercised with mocked process maps, then a REAL mesh built under a
mocked process partition of the 8 virtual CPU devices runs
distributed_sketch end to end — correctness must be invariant to the
device order inside the mesh (counter addressing follows mesh
coordinates, never device ids)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from randblas_tpu import DenseDist, DenseSkOp, RNGState
from randblas_tpu.parallel import (
    arrange_multihost_devices, distributed_sketch, make_multihost_sketch_mesh,
    make_sketch_mesh,
)


class FakeDev:
    def __init__(self, id, process_index):
        self.id = id
        self.process_index = process_index

    def __repr__(self):
        return f"d{self.id}@p{self.process_index}"


def _fleet(num_procs, per):
    # ids deliberately interleaved across processes so "sorted by id"
    # and "grouped by process" differ — catches id-order shortcuts.
    return [FakeDev(p + num_procs * i, p)
            for p in range(num_procs) for i in range(per)]


def test_model_within_process_data_process_major():
    devs = _fleet(num_procs=4, per=4)
    arr = arrange_multihost_devices(devs, model=2)
    assert arr.shape == (2, 8)
    # every data column-block of width per/model = 2 is ONE process,
    # in process-rank order
    for rank in range(4):
        block = arr[:, 2 * rank:2 * rank + 2]
        procs = {d.process_index for d in block.ravel()}
        assert procs == {rank}
    # 'model' never crosses a process boundary
    for j in range(8):
        assert len({d.process_index for d in arr[:, j]}) == 1
    # all devices used exactly once
    assert sorted(d.id for d in arr.ravel()) == sorted(d.id for d in devs)


def test_model_spanning_whole_processes():
    devs = _fleet(num_procs=4, per=2)
    arr = arrange_multihost_devices(devs, model=4, data=2)
    assert arr.shape == (4, 2)
    # each model row-block of height per=2 within a column is one process
    for g in range(2):
        for j in range(2):
            block = arr[2 * g:2 * g + 2, j]
            assert len({d.process_index for d in block}) == 1
    # model-group-major process placement: rank r -> (r // data, r % data)
    assert arr[0, 0].process_index == 0
    assert arr[0, 1].process_index == 1
    assert arr[2, 0].process_index == 2
    assert sorted(d.id for d in arr.ravel()) == sorted(d.id for d in devs)


def test_single_process_matches_make_sketch_mesh_layout():
    devs = [FakeDev(i, 0) for i in range(8)]
    arr = arrange_multihost_devices(devs, model=2)
    want = np.array(sorted(devs, key=lambda d: d.id),
                    dtype=object).reshape(2, 4)
    assert all(a is b for a, b in zip(arr.ravel(), want.ravel()))


def test_rejects_uneven_and_straddling_configs():
    uneven = [FakeDev(0, 0), FakeDev(1, 0), FakeDev(2, 1)]
    with pytest.raises(ValueError, match="same number"):
        arrange_multihost_devices(uneven, model=1)
    devs = _fleet(num_procs=3, per=4)   # 12 devices
    with pytest.raises(ValueError, match="split a process"):
        arrange_multihost_devices(devs, model=6, data=2)  # 6 !| 4, 4 !| 6
    with pytest.raises(ValueError, match="mesh"):
        arrange_multihost_devices(devs, model=2, data=2)  # 2*2 != 12
    with pytest.raises(ValueError, match="not divisible"):
        arrange_multihost_devices(devs, model=5)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_real_mesh_mocked_processes_end_to_end():
    """Partition the 8 CPU devices into 4 mock 'processes' of 2; the
    multihost mesh permutes device order relative to make_sketch_mesh,
    and the sketch must be bitwise-invariant to that permutation."""
    mock_proc = lambda d: d.id // 2
    mesh = make_multihost_sketch_mesh(model=2, data=4,
                                      process_index_of=mock_proc)
    # layout sanity on the real device array
    arr = mesh.devices
    for rank in range(4):
        assert {d.id // 2 for d in arr[:, rank].ravel()} == {rank}
    S = DenseSkOp(DenseDist(16, 64), RNGState.from_key(5))
    A = jnp.asarray(np.random.default_rng(0)
                    .normal(size=(64, 8)).astype(np.float32))
    got = np.asarray(distributed_sketch(S, A, mesh))
    ref = np.asarray(distributed_sketch(S, A, make_sketch_mesh(2, 4)))
    np.testing.assert_array_equal(got, ref)
    want = np.asarray(S.materialize()) @ np.asarray(A)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_real_mesh_model_spanning_processes_end_to_end():
    """model=4 over mock processes of 2 devices: processes stack along
    'model' (the model % per == 0 regime) and the sketch still matches."""
    mesh = make_multihost_sketch_mesh(model=4, data=2,
                                      process_index_of=lambda d: d.id // 2)
    S = DenseSkOp(DenseDist(12, 40), RNGState.from_key(9))
    A = jnp.asarray(np.random.default_rng(1)
                    .normal(size=(40, 6)).astype(np.float32))
    got = np.asarray(distributed_sketch(S, A, mesh))
    want = np.asarray(S.materialize()) @ np.asarray(A)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_live_two_process_distributed_sketch():
    """LIVE multi-process run — not a mock: two OS processes, each with
    its own 2-device virtual CPU backend, jax.distributed over a
    localhost coordinator, cross-process psum through XLA's gloo CPU
    collectives (the same collective machinery a multi-host cluster
    uses, modulo transport). Each worker builds the process-contiguous
    mesh, runs distributed_sketch (aligned + pad-and-shard), and
    oracle-checks its addressable shards.

    slow tier: two full interpreter + XLA + gloo startups (~22 s).
    The bind-then-close port probe races other processes on the
    machine, so a failed coordinator bind is retried on a fresh port."""
    import socket
    import subprocess
    import sys
    from pathlib import Path

    worker = Path(__file__).with_name("_multihost_worker.py")
    env = {k: v for k, v in __import__("os").environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}

    def run_once():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        coord = f"localhost:{port}"
        procs = [subprocess.Popen(
                     [sys.executable, str(worker), coord, str(i), "2"],
                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                     text=True, env=env, cwd=str(worker.parent.parent))
                 for i in range(2)]
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            outs.append(out)
        return procs, outs

    procs, outs = run_once()
    if any(p.returncode != 0 for p in procs) and \
            any("bind" in o.lower() or "address" in o.lower()
                for o in outs):
        procs, outs = run_once()       # port was stolen between probe
        #                                and coordinator bind; retry once
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"proc {i}: OK" in out, f"worker {i} output:\n{out}"
