"""Scoped overrides for the library's dispatch flags.

The reference's configuration surface is compile-time only
(RandBLAS/config.h.in:1-55); this library's runtime dispatch policy
lives in a handful of module-level flags (`skge.use_fused`,
`skge.use_hiprec_f64`, `dense.use_native_x64`).
Setting them directly works but leaks across call sites; `flags(...)`
scopes an override and guarantees restoration::

    with randblas_tpu.flags(use_fused=False):
        B = randblas_tpu.sketch(S, A)      # staged fill+GEMM, always

NOTE: the flags are read at TRACE time. A jitted function captures the
values in effect when it is first traced; re-entering the context does
not retrace already-compiled callables.
"""

from __future__ import annotations

import contextlib

# flag name -> module path holding it
_FLAG_HOMES = {
    "use_fused": "randblas_tpu.skge",
    "use_hiprec_f64": "randblas_tpu.skge",
    "use_native_x64": "randblas_tpu.dense",
}


def _home(name: str):
    import importlib
    try:
        mod_path = _FLAG_HOMES[name]
    except KeyError:
        raise ValueError(
            f"unknown randblas_tpu flag {name!r}; known flags: "
            f"{sorted(_FLAG_HOMES)}") from None
    return importlib.import_module(mod_path)


def get_flag(name: str):
    """Current value of a dispatch flag (see `flags` for the list)."""
    return getattr(_home(name), name)


def set_flag(name: str, value) -> None:
    """Set a dispatch flag globally (prefer the `flags` context)."""
    setattr(_home(name), name, value)


@contextlib.contextmanager
def flags(**overrides):
    """Context manager scoping dispatch-flag overrides.

    Accepted keys: use_fused ("auto"/True/False), use_hiprec_f64
    ("auto"/True/False), use_native_x64 ("auto"/False). Values are
    restored on exit even if the body raises.
    """
    saved = {name: get_flag(name) for name in overrides}
    try:
        for name, value in overrides.items():
            set_flag(name, value)
        yield
    finally:
        for name, value in saved.items():
            set_flag(name, value)
