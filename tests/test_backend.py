"""The backend query and what reads it: dispatch keyed on "gpu"/"cpu",
the compile-cache placement, the native library's rebuild rule, and
chip_smoke.py's refusal to run without a GPU. All on the CPU: no GPU
kernel runs here."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import randblas_tpu as rb
from randblas_tpu import backend, bench_util, native, skge
from randblas_tpu.ops import fused_sketch as fs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_backend_query_reads_default_backend():
    assert backend.platform() == jax.default_backend() == "cpu"
    assert backend.on_gpu() is False


@pytest.fixture
def on_gpu(monkeypatch):
    """Dispatch as if JAX's default backend were the GPU; the kernel is
    replaced by a recorder, so nothing GPU-only runs."""
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    calls = []

    def record(S, A, **kw):
        calls.append((S.dist.n_rows, S.dist.n_cols, A.shape, kw))
        return jnp.zeros((kw["rows_s"], A.shape[1]), jnp.float32)

    monkeypatch.setattr(fs, "fused_sketch", record)
    return calls


@pytest.mark.parametrize("d,m,n,kernel", [
    (1024, 1 << 18, 128, True),    # tall-skinny: measured win
    (256, 1 << 20, 64, True),
    (1024, 65536, 4096, False),    # headline: measured 7x loss
    (1024, 1 << 20, 256, False),   # two column tiles: measured loss
    (1024, 1 << 17, 128, False),   # shorter than any measured win
])
def test_gpu_dispatch_rule(on_gpu, d, m, n, kernel):
    S = rb.DenseSkOp(rb.DenseDist(d, m), rb.RNGState.from_key(0))
    A = jax.ShapeDtypeStruct((m, n), jnp.float32)
    jax.eval_shape(lambda a: rb.sketch_general(S, a), A)
    assert bool(on_gpu) is kernel
    assert fs.fused_profitable(d, m, n) is kernel


def test_gpu_dispatch_transposed_and_right(on_gpu):
    """op_s='T' and right sketches reach the kernel through the
    autotranspose of the operator (shape-only trace)."""
    m, d, n = 1 << 18, 64, 16
    tall = rb.DenseSkOp(rb.DenseDist(m, d), rb.RNGState.from_key(1))
    jax.eval_shape(lambda a: rb.sketch_general(tall, a, op_s="T", d=d),
                   jax.ShapeDtypeStruct((m, n), jnp.float32))
    jax.eval_shape(lambda a: rb.sketch_general(tall, a, side="right"),
                   jax.ShapeDtypeStruct((n, m), jnp.float32))
    assert [c[:2] for c in on_gpu] == [(d, m), (d, m)]


def test_cpu_dispatch_never_takes_kernel(monkeypatch):
    calls = []
    monkeypatch.setattr(fs, "fused_sketch",
                        lambda *a, **k: calls.append(1))
    S = rb.DenseSkOp(rb.DenseDist(64, 1 << 18), rb.RNGState.from_key(2))
    jax.eval_shape(lambda a: rb.sketch_general(S, a),
                   jax.ShapeDtypeStruct((1 << 18, 8), jnp.float32))
    assert not calls


def test_forced_kernel_unsupported_raises():
    """use_fused=True on a call the kernel cannot take is an error, not
    a silent staged fallback (a square operator has no autotranspose)."""
    S = rb.DenseSkOp(rb.DenseDist(32, 32), rb.RNGState.from_key(3))
    with rb.flags(use_fused=True):
        with pytest.raises(ValueError, match="forced"):
            rb.sketch_general(S, jnp.ones((32, 4)), op_s="T")


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert bench_util.use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # set by JAX


def test_compile_cache_fixed_path_in_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = bench_util.use_compile_cache()
        assert got == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("so_age,src_age,want", [
    (None, 10, True),     # missing library
    (5, 10, True),        # older than a source
    (10, 5, False),       # newer than every source
])
def test_native_rebuild_rule(tmp_path, so_age, src_age, want):
    srcs = [tmp_path / "randblas_host.cpp", tmp_path / "Makefile"]
    for s in srcs:
        s.write_text("x")
        os.utime(s, (src_age, src_age))
    so = tmp_path / "librandblas_host.so"
    if so_age is not None:
        so.write_text("x")
        os.utime(so, (so_age, so_age))
    assert native.needs_build(str(so), [str(s) for s in srcs]) is want


def test_native_makefile_is_portable():
    """The library may be built on one machine and run on another: no
    -march=native."""
    with open(os.path.join(ROOT, "native", "Makefile")) as f:
        assert "march=native" not in f.read()


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_gpu():
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "needs a GPU" in res.stdout + res.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_seed_words_layout():
    """(8,) kernel seed: counter, key, zero padding."""
    st = rb.RNGState.from_key(7)
    w = np.asarray(fs.seed_words(st.counter, st.key))
    assert w.shape == (8,) and w.dtype == np.uint32
    np.testing.assert_array_equal(w[:4], np.asarray(st.counter))
    np.testing.assert_array_equal(w[4:6], np.asarray(st.key))
    np.testing.assert_array_equal(w[6:], 0)


@pytest.mark.parametrize("axis,d,m,n", [(0, 1024, 1 << 20, 128),
                                        (0, 13, 100, 3),
                                        (1, 1024, 1 << 20, 128),
                                        (1, 13, 100, 3)])
def test_kernel_plan(axis, d, m, n):
    """Power-of-two tiles with every dot dimension >= 16, padded extents
    that cover the problem, and enough programs to fill an H100."""
    d_pad, m_pad, n_pad, ti, tk, tn, splits, steps = fs._plan(d, m, n,
                                                              axis)
    for t in (ti, tk, tn):
        assert t & (t - 1) == 0
    assert min(ti if axis == 0 else ti // 4, tk // 4 if axis == 0 else tk,
               tn) >= 16
    assert d_pad >= d and d_pad % ti == 0
    assert n_pad >= n and n_pad % tn == 0
    assert m_pad == splits * steps * tk >= m
    assert m_pad - m < steps * tk
    if d >= 1024:
        assert (d_pad // ti) * (n_pad // tn) * splits >= 1000
