"""ctypes bindings for the native host engine (native/randblas_host.cpp).

The native library is optional: ``available()`` gates every entry point,
and the pure-JAX paths are always present. Build with ``make -C native``;
this module also builds it on first use when a compiler is present and
the .so is missing or older than its sources (``needs_build``), so a
library built on another machine is never loaded stale.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "librandblas_host.so")
_SOURCES = ("randblas_host.cpp", "Makefile")


def needs_build(so_path: str = _SO_PATH,
                sources=tuple(os.path.join(_NATIVE_DIR, f)
                              for f in _SOURCES)) -> bool:
    """True when the library is missing or older than any source."""
    if not os.path.exists(so_path):
        return True
    built = os.path.getmtime(so_path)
    return any(os.path.getmtime(src) > built for src in sources
               if os.path.exists(src))


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if needs_build():
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR],
                           check=True, capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.rbt_philox4x32.argtypes = [u32p, u32p, ctypes.c_int,
                                   ctypes.c_int64, u32p]
    lib.rbt_threefry4x32.argtypes = [u32p, u32p, ctypes.c_int,
                                     ctypes.c_int64, u32p]
    lib.rbt_fill_rowmajor.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        u32p, u32p, ctypes.c_int, f32p]
    lib.rbt_fill_rowmajor_g.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        u32p, u32p, ctypes.c_int, ctypes.c_int, f32p]
    lib.rbt_fisher_yates.argtypes = [
        u32p, u32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i64p, f32p]
    lib.rbt_fisher_yates_g.argtypes = [
        u32p, u32p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, i64p, f32p]
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.rbt_cbrng64.argtypes = [ctypes.c_int, u64p, u64p, ctypes.c_int,
                                ctypes.c_int64, u64p]
    lib.rbt_fill_rowmajor64_g.argtypes = [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, u64p, u64p, ctypes.c_int, f64p]
    _LIB = lib
    return _LIB


_RNG_IDS = {"philox4x32": 0, "threefry4x32": 1}


def _rng_id(rng: str) -> int:
    if rng not in _RNG_IDS:
        raise ValueError(f"native engine: unsupported rng {rng!r}")
    return _RNG_IDS[rng]


def _pad_key(key: np.ndarray, rng: str) -> np.ndarray:
    """Threefry reads 4 key words; pad shorter keys with zeros."""
    key = np.ascontiguousarray(key, dtype=np.uint32)
    need = 4 if rng == "threefry4x32" else 2
    if key.shape[0] < need:
        key = np.concatenate(
            [key, np.zeros(need - key.shape[0], np.uint32)])
    return key


def available() -> bool:
    return _load() is not None


def philox4x32(ctrs: np.ndarray, key: np.ndarray,
               rounds: int = 10) -> np.ndarray:
    """Raw Philox blocks for uint32 counters of shape (n, 4)."""
    lib = _load()
    assert lib is not None, "native library unavailable"
    ctrs = np.ascontiguousarray(ctrs, dtype=np.uint32).reshape(-1, 4)
    key = np.ascontiguousarray(key, dtype=np.uint32)
    out = np.empty_like(ctrs)
    lib.rbt_philox4x32(ctrs, key, rounds, ctrs.shape[0], out)
    return out


def threefry4x32(ctrs: np.ndarray, key: np.ndarray,
                 rounds: int = 20) -> np.ndarray:
    """Raw Threefry4x32 blocks for uint32 counters of shape (n, 4)."""
    lib = _load()
    assert lib is not None, "native library unavailable"
    ctrs = np.ascontiguousarray(ctrs, dtype=np.uint32).reshape(-1, 4)
    key = _pad_key(key, "threefry4x32")
    out = np.empty_like(ctrs)
    lib.rbt_threefry4x32(ctrs, key, rounds, ctrs.shape[0], out)
    return out


_CBRNG64 = {"philox2x64": (0, 2, 1), "philox4x64": (1, 4, 2),
            "threefry2x64": (2, 2, 2), "threefry4x64": (3, 4, 4)}


def cbrng64(name: str, ctrs: np.ndarray, key: np.ndarray,
            rounds: int) -> np.ndarray:
    """Raw 64-bit CBRNG blocks (host-only: JAX runs them without x64 mode).

    name: philox2x64 | philox4x64 | threefry2x64 | threefry4x64;
    ctrs: uint64 of shape (n, width). Closes the reference's Random123 x64
    surface (KAT-replayed in tests/test_rng_kat.py).
    """
    lib = _load()
    assert lib is not None, "native library unavailable"
    gen, width, key_words = _CBRNG64[name]
    ctrs = np.ascontiguousarray(ctrs, dtype=np.uint64).reshape(-1, width)
    key = np.ascontiguousarray(key, dtype=np.uint64)
    assert key.shape[0] >= key_words, f"{name} needs {key_words} key words"
    out = np.empty_like(ctrs)
    lib.rbt_cbrng64(gen, ctrs, key, rounds, ctrs.shape[0], out)
    return out


def fill_rowmajor(n_cols_parent: int, n_srows: int, n_scols: int,
                  ptr: int, ctr: np.ndarray, key: np.ndarray,
                  gaussian: bool, rng: str = "philox4x32") -> np.ndarray:
    lib = _load()
    assert lib is not None, "native library unavailable"
    ctr = np.ascontiguousarray(ctr, dtype=np.uint32)
    key = _pad_key(key, rng)
    out = np.empty((n_srows, n_scols), dtype=np.float32)
    lib.rbt_fill_rowmajor_g(n_cols_parent, n_srows, n_scols, ptr, ctr,
                            key, _rng_id(rng), int(gaussian), out)
    return out


def fill_rowmajor64(n_cols_parent: int, n_srows: int, n_scols: int,
                    ptr: int, ctr: np.ndarray, key: np.ndarray,
                    gaussian: bool, rng: str = "philox4x64") -> np.ndarray:
    """Native-f64 counter-addressed fill through the x64 CBRNGs
    (independent cross-check of rng/x64.py::fill_rowmajor64). ctr/key
    are uint64 WORD arrays."""
    lib = _load()
    assert lib is not None, "native library unavailable"
    gen, width, key_words = _CBRNG64[rng]
    ctr = np.ascontiguousarray(ctr, dtype=np.uint64)
    key = np.ascontiguousarray(key, dtype=np.uint64)
    assert ctr.shape[0] == width and key.shape[0] >= key_words
    out = np.empty((n_srows, n_scols), dtype=np.float64)
    lib.rbt_fill_rowmajor64_g(gen, n_cols_parent, n_srows, n_scols, ptr,
                              ctr, key, int(gaussian), out)
    return out


def fisher_yates(ctr: np.ndarray, key: np.ndarray, vec_nnz: int,
                 dim_major: int, dim_minor: int,
                 rng: str = "philox4x32"):
    lib = _load()
    assert lib is not None, "native library unavailable"
    ctr = np.ascontiguousarray(ctr, dtype=np.uint32)
    key = _pad_key(key, rng)
    idxs = np.empty((dim_minor, vec_nnz), dtype=np.int64)
    vals = np.empty((dim_minor, vec_nnz), dtype=np.float32)
    lib.rbt_fisher_yates_g(ctr, key, _rng_id(rng), vec_nnz, dim_major,
                           dim_minor, idxs.reshape(-1), vals.reshape(-1))
    return idxs, vals
