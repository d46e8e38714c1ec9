"""Multi-host (multi-process) mesh construction for distributed sketching.

SURVEY §2.3 specifies JAX collectives within *and across* hosts.
Everything in
``distributed.py`` is mesh-shape agnostic — counter addressing gives each
device its tile of the global operator from (seed, mesh coordinates)
alone, so nothing in the sketching math changes across hosts. What DOES
change is the cost model: the inter-host network is an order of
magnitude slower than the intra-host links (NVLink between GPUs), so
the *device order inside the mesh* decides whether the one collective
these kernels issue (the psum of partial products over 'data')
decomposes hierarchically (reduce-scatter inside the host -> small
all-reduce across hosts -> all-gather inside the host) or naively
streams full tiles across hosts.

This module builds ('model', 'data') meshes whose device order is
**process-contiguous**:

* ``model`` fits inside each process whenever it divides the local
  device count — the 'model' axis (output rows; all-gathers in consumer
  code) then never crosses hosts;
* ``data`` is process-major — consecutive blocks of the 'data' axis
  belong to one process, which is the layout XLA's hierarchical
  all-reduce needs to keep the cross-host leg at 1/(local size) of the
  bytes.

Launch recipe (one process per host; see docs/distributed.md for the
full walkthrough):

    # on every host, same program:
    import randblas_tpu.parallel as par
    par.initialize_multihost()            # env-configured clusters, or
    # par.initialize_multihost("host0:8476", num_processes=4, process_id=i)
    mesh = par.make_multihost_sketch_mesh(model=2)
    B = par.distributed_sketch(S, A, mesh)   # unchanged from single-host

The path is exercised without a cluster: tests/test_multihost.py spawns TWO OS
processes, each with its own 2-device CPU backend, initializes
``jax.distributed`` over a localhost coordinator, and runs
``distributed_sketch`` (aligned + pad-and-shard) through XLA's gloo
cross-process collectives — the same collective machinery a multi-host
cluster uses, modulo transport. The arrangement logic is
additionally covered with mocked process maps. Reference: ABSENT
(RandBLAS is single-node OpenMP; SURVEY §2.3 rows 2-5).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
from jax.sharding import Mesh

from ..base import require


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         **kwargs) -> None:
    """Initialize the JAX multi-process runtime (thin, documented wrapper
    over ``jax.distributed.initialize``).

    On clusters launched through a scheduler JAX supports every argument
    is discovered from the environment — call with no arguments, once, at
    program start, before any other JAX call. Elsewhere pass the
    coordinator's ``host:port``, the total process count, and this
    process's rank. After it returns, ``jax.devices()`` lists the
    devices of ALL processes (each annotated with ``process_index``) and
    ``jax.local_devices()`` this host's — exactly the inputs
    ``make_multihost_sketch_mesh`` consumes.
    """
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id, **kwargs)


def _group_by_process(devices, process_index_of=None):
    """Ordered {process_index: [devices sorted by id]}; validates that
    every process exposes the same device count (JAX requires this for
    dense meshes)."""
    key = process_index_of or (lambda d: d.process_index)
    groups = {}
    for dev in devices:
        groups.setdefault(key(dev), []).append(dev)
    proc_ids = sorted(groups)
    per = len(groups[proc_ids[0]])
    require(all(len(groups[p]) == per for p in proc_ids),
            "every process must expose the same number of devices "
            f"(got {[len(groups[p]) for p in proc_ids]})")
    return {p: sorted(groups[p], key=lambda d: d.id) for p in proc_ids}


def arrange_multihost_devices(devices, model: int,
                              data: Optional[int] = None, *,
                              process_index_of=None) -> np.ndarray:
    """A (model, data) device array with process-contiguous order.

    Two regimes:

    * ``model`` divides the per-process device count: each process
      contributes a (model, per/model) tile and tiles concatenate along
      'data' in process-rank order. 'model' never crosses a process
      boundary; 'data' is process-major.
    * ``model`` spans whole processes (``model % per == 0``): processes
      stack along 'model' in groups of ``model/per``, model-group-major
      (process rank r -> model group r // data, data column r % data).
      Each process's devices stay contiguous along 'model'.

    Anything else (model neither dividing nor divisible by the local
    device count would split a process across BOTH axes) is rejected.
    ``process_index_of`` overrides the grouping key for tests/dry-runs.
    """
    groups = _group_by_process(devices, process_index_of)
    proc_ids = list(groups)
    per = len(groups[proc_ids[0]])
    n = per * len(proc_ids)
    if data is None:
        require(n % model == 0, f"{n} devices not divisible by model={model}")
        data = n // model
    require(model * data == n,
            f"mesh {model}x{data} != {n} devices across "
            f"{len(proc_ids)} processes")
    arr = np.empty((model, data), dtype=object)
    if per % model == 0:
        dpp = per // model                       # data shards per process
        for rank, p in enumerate(proc_ids):
            tile = np.array(groups[p], dtype=object).reshape(model, dpp)
            arr[:, rank * dpp:(rank + 1) * dpp] = tile
    elif model % per == 0:
        ppg = model // per                       # processes per model column
        require(len(proc_ids) == ppg * data,
                f"model={model} spanning {ppg} processes/column needs "
                f"{ppg * data} processes, have {len(proc_ids)}")
        for rank, p in enumerate(proc_ids):
            g, j = divmod(rank, data)
            arr[g * per:(g + 1) * per, j] = np.array(groups[p], dtype=object)
    else:
        require(False,
                f"model={model} neither divides nor is divisible by the "
                f"per-process device count {per}; such a mesh would split "
                "a process across both axes (cross-host traffic on every "
                "collective)")
    return arr


def make_multihost_sketch_mesh(model: int = 1, data: Optional[int] = None,
                               *, devices=None,
                               process_index_of=None) -> Mesh:
    """A ('model', 'data') Mesh over all processes' devices with
    cross-host-friendly (process-contiguous) device order — the multi-host
    counterpart of ``make_sketch_mesh``. Call after
    ``initialize_multihost()``; every process must call it with the same
    arguments (meshes are global objects in multi-process JAX).

    On a single process this reduces exactly to ``make_sketch_mesh``'s
    row-major layout, so it is always safe to use.
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    arr = arrange_multihost_devices(devices, model, data,
                                    process_index_of=process_index_of)
    return Mesh(arr, ("model", "data"))
