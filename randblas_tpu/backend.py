"""The one backend query that every dispatch decision reads.

Routes are keyed on the platform name JAX reports for its default
backend: ``"gpu"`` (CUDA) takes the GPU kernels where they measured
faster, everything else (``"cpu"``) takes the plain XLA routes. Nothing
here catches an error: a backend that fails to start fails loudly.
"""

from __future__ import annotations

import jax


def platform() -> str:
    """Platform name of JAX's default backend ("gpu", "cpu", ...)."""
    return jax.default_backend()


def on_gpu() -> bool:
    return platform() == "gpu"
