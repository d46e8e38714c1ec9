"""Benchmark helpers: host-clock timing, device identity, compile cache.

Times come from the host clock around work that ends in
``block_until_ready``, after warm-up calls that compile every shape the
timed calls use. A measurement needs the GPU: ``require_gpu`` fails when
JAX finds none, and every result names the device it ran on
(``device_info``), so that no CPU number is read as a device number.
"""

from __future__ import annotations

import os
import subprocess
import time

import jax
import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The compile cache's fixed path inside the checkout (listed in
# .gitignore): the path is part of the cache key, so it must not move.
CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def use_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory:
    ``$JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it itself),
    otherwise ``CACHE_DIR``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def require_gpu() -> None:
    """Raise unless JAX's default backend is a GPU."""
    platform = jax.default_backend()
    if platform != "gpu":
        raise SystemExit(
            f"needs a GPU: JAX's default backend is {platform!r}")


def nvidia_smi() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_info() -> dict:
    """The device as JAX reports it, for result lines."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def time_host(fn, *operands, warmup: int = 2, iters: int = 5) -> float:
    """Median seconds per call of ``jax.jit(fn)(*operands)``: host clock
    around each call's ``block_until_ready``, after ``warmup`` calls."""
    f = jax.jit(fn)
    for _ in range(warmup):
        jax.block_until_ready(f(*operands))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*operands))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))
