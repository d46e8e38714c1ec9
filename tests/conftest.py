"""Test configuration: the suite runs on the CPU with a virtual 8-device
mesh (``JAX_PLATFORMS=cpu python -m pytest tests/``).

Sharding correctness is validated on host-platform virtual devices; the
GPU tier (tests/test_gpu_hardware.py, marker ``gpu``) skips on the CPU
and runs on the card through ``python chip_smoke.py``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


def pytest_collection_modifyitems(config, items):
    """Two-tier suite (the reference splits its tests into four
    executables for the same reason, test/CMakeLists.txt): `pytest -q`
    runs the fast tier; tests marked `slow` (statistical sweeps,
    distributed mesh lattices) need RBT_FULL_SUITE=1 or an explicit
    -m selection."""
    if os.environ.get("RBT_FULL_SUITE"):
        return
    if config.getoption("-m"):
        return  # user picked markers explicitly; don't second-guess
    skip_slow = pytest.mark.skip(
        reason="slow tier: set RBT_FULL_SUITE=1 (or -m slow) to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)
