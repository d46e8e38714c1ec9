"""Generator genericity: dense/sparse operators over non-default CBRNGs.

The reference templates RNGState over any Random123 CBRNG; here the fill
and FY engines are generic over the registered generators (state.generate
+ counter width), so Threefry-backed operators work end-to-end.
"""

import numpy as np
import pytest

from randblas_tpu import (
    DenseDist, DenseDistName, RNGState, fill_dense_submat,
    repeated_fisher_yates, sketch_general, DenseSkOp,
)


@pytest.mark.parametrize("rng_name", ["threefry4x32", "philox2x32",
                                      "threefry2x32"])
def test_dense_fill_other_generators(rng_name):
    dist = DenseDist(6, 14)
    state = RNGState.from_key(9, rng=rng_name)
    full = np.asarray(fill_dense_submat(dist, state, 6, 14))
    assert np.isfinite(full).all()
    assert abs(full.mean()) < 0.5  # sanity, tiny sample
    # submatrix addressing must hold for any counter width
    block = np.asarray(fill_dense_submat(dist, state, 3, 5, 2, 4))
    np.testing.assert_array_equal(block, full[2:5, 4:9])


def test_streams_differ_across_generators():
    dist = DenseDist(8, 8)
    a = np.asarray(fill_dense_submat(dist, RNGState.from_key(1), 8, 8))
    b = np.asarray(fill_dense_submat(
        dist, RNGState.from_key(1, rng="threefry4x32"), 8, 8))
    assert not np.allclose(a, b)


def test_fisher_yates_threefry():
    idxs, vals = repeated_fisher_yates(
        RNGState.from_key(3, rng="threefry4x32"), 3, 10, 6)
    idxs = np.asarray(idxs)
    for row in idxs:
        assert len(set(row.tolist())) == 3
    assert set(np.unique(np.asarray(vals))) <= {-1.0, 1.0}


def test_sketch_with_threefry_operator():
    S = DenseSkOp(DenseDist(4, 20),
                  RNGState.from_key(2, rng="threefry4x32"))
    A = np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32)
    got = np.asarray(sketch_general(S, A))
    want = np.asarray(S.materialize()) @ A
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_threefry_never_hits_philox_kernel(monkeypatch):
    """The RNG-in-GEMM kernel generates only the 4x32 counter-based
    streams; a 2x32 operator must never be dispatched to it (that would
    silently change the stream), even where the GPU rule takes it."""
    import jax.numpy as jnp
    import randblas_tpu as rb
    from randblas_tpu.base import Op
    from randblas_tpu.ops import fused_sketch as fs
    from randblas_tpu.skge import _fused_or_none

    monkeypatch.setattr(rb.backend, "platform", lambda: "gpu")
    monkeypatch.setattr(fs, "fused_sketch", lambda *a, **k: "kernel")
    d, m, n = 64, 1 << 18, 8
    a = jnp.zeros((m, n), jnp.float32)
    for rng, routed in (("philox2x32", False), ("threefry2x32", False),
                        ("threefry4x32", True), ("philox4x32", True)):
        S = DenseSkOp(DenseDist(d, m), RNGState.from_key(1, rng=rng))
        got = _fused_or_none(S, a, d, m, 0, 0, Op.NoTrans, jnp.float32,
                             1.0)
        assert (got == "kernel") is routed, rng
