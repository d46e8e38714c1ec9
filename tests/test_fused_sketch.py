"""RNG-in-GEMM kernel: interpreter-mode coverage on CPU.

The compiled kernel is exercised on the GPU (tests/test_gpu_hardware.py,
run by chip_smoke.py); here the kernel logic (counter addressing inside
tiles, lane-split contraction, split-K accumulation, padding) runs under
the Pallas interpreter against the materialize oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from randblas_tpu import DenseDist, DenseDistName, DenseSkOp, RNGState
from randblas_tpu.ops.fused_sketch import (
    fused_sketch, fused_sketch_supported,
)


@pytest.mark.parametrize("family", [DenseDistName.Gaussian,
                                    DenseDistName.Uniform])
@pytest.mark.slow
def test_fused_interpret_matches_materialize(family):
    d, m, n = 16, 512, 128
    S = DenseSkOp(DenseDist(d, m, family), RNGState.from_key(3))
    A = jnp.asarray(
        np.random.default_rng(0).normal(size=(m, n)).astype(np.float32))
    got = np.asarray(fused_sketch(S, A, alpha=0.5, interpret=True))
    want = 0.5 * np.asarray(S.materialize()) @ np.asarray(A)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-2)


def test_fused_multi_panel_accumulation():
    # multiple k panels and j blocks
    d, m, n = 8, 2048, 256
    S = DenseSkOp(DenseDist(d, m), RNGState.from_key(9))
    A = jnp.asarray(
        np.random.default_rng(1).normal(size=(m, n)).astype(np.float32))
    got = np.asarray(fused_sketch(S, A, interpret=True))
    want = np.asarray(S.materialize()) @ np.asarray(A)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-2)


def test_fused_submatrix_interpret():
    """Counter-aligned submatrix blocks generated in-kernel equal slices
    of the full operator."""
    big = DenseSkOp(DenseDist(32, 1024), RNGState.from_key(5))
    rows_s, cols_s, ro, co = 16, 512, 8, 256
    A = jnp.asarray(
        np.random.default_rng(2).normal(size=(cols_s, 128)).astype(
            np.float32))
    got = np.asarray(fused_sketch(big, A, interpret=True, rows_s=rows_s,
                                  cols_s=cols_s, ro_s=ro, co_s=co))
    blk = np.asarray(big.materialize())[ro:ro + rows_s, co:co + cols_s]
    want = blk @ np.asarray(A)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-2)


def test_fused_padded_shapes_interpret():
    """d and n padding: odd sketch size and non-128 data width."""
    S = DenseSkOp(DenseDist(13, 512), RNGState.from_key(8))
    A = jnp.asarray(
        np.random.default_rng(3).normal(size=(512, 100)).astype(
            np.float32))
    got = np.asarray(fused_sketch(S, A, interpret=True))
    want = np.asarray(S.materialize()) @ np.asarray(A)
    assert got.shape == (13, 100)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-2)


def test_supported_predicate():
    g = DenseDist(64, 1024)
    ok = lambda dist, r, c, ro, co, dt=jnp.float32, rng="philox4x32": \
        fused_sketch_supported(dist, r, c, ro, co, dt, rng)  # noqa: E731
    assert ok(g, 64, 1024, 0, 0)
    # counter-aligned and unaligned submatrices -> yes
    assert ok(g, 32, 512, 4, 256)
    assert ok(g, 32, 512, 0, 2)
    # out of range -> no
    assert not ok(g, 64, 1024, 4, 0)
    # f64 -> no; bf16 -> yes
    assert not ok(g, 64, 1024, 0, 0, jnp.float64)
    assert ok(g, 64, 1024, 0, 0, jnp.bfloat16)
    # both natural layouts: tall Long (ColMajor natural) -> yes
    assert ok(DenseDist(1024, 64), 1024, 64, 0, 0)
    # only the 4x32 counter-based generators
    assert ok(g, 64, 1024, 0, 0, rng="threefry4x32")
    assert not ok(g, 64, 1024, 0, 0, rng="philox2x32")
    assert not ok(DenseDist(64, 1024, DenseDistName.BlackBox), 64, 1024,
                  0, 0)


# --------------------- generator stream of the kernel -----------------------

class TestPallasFill:
    """The kernel's in-register generator against the XLA fill: a sketch
    of the identity is the operator block itself. uint32 streams are
    identical by construction; Uniform floats exact, Gaussian floats
    within the ~1-ulp transcendental tolerance (rng/transforms.py)."""

    @pytest.mark.parametrize("shape,ma", [
        ((64, 256), None),            # wide + Long: RowMajor natural
        ((256, 64), None),            # tall + Long: ColMajor natural
    ])
    @pytest.mark.parametrize("fam", [DenseDistName.Gaussian,
                                     DenseDistName.Uniform])
    @pytest.mark.slow
    def test_block_matches_xla_fill(self, shape, ma, fam):
        from randblas_tpu.dense import fill_dense_submat
        R, C = shape
        dist = (DenseDist(R, C, fam) if ma is None
                else DenseDist(R, C, fam, ma))
        S = DenseSkOp(dist, RNGState.from_key(5))
        for (rs, cs, ro, co) in [(R, C, 0, 0), (32, 48, 8, 13),
                                 (17, 33, 3, 2)]:
            eye = jnp.eye(cs, dtype=jnp.float32)
            got = np.asarray(fused_sketch(S, eye, interpret=True,
                                          rows_s=rs, cols_s=cs, ro_s=ro,
                                          co_s=co))
            want = np.asarray(fill_dense_submat(dist, S.seed_state, rs,
                                                cs, ro, co))
            if fam == DenseDistName.Uniform:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6,
                                           atol=1e-6)

    def test_staged_dispatch_matches_kernel(self):
        """use_fused=False (the staged XLA fill + GEMM) and the forced
        kernel agree on the same sketch."""
        import randblas_tpu.skge as skge
        from randblas_tpu import sketch_general
        d, m, n = 24, 96, 16
        S = DenseSkOp(DenseDist(d, m), RNGState.from_key(9))
        A = jnp.asarray(np.random.default_rng(0).normal(
            size=(m, n)).astype(np.float32))
        old = skge.use_fused
        try:
            skge.use_fused = False
            want = np.asarray(sketch_general(S, A))
        finally:
            skge.use_fused = old
        got = np.asarray(fused_sketch(S, A, interpret=True))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
