"""GPU tier: the library's compiled routes on a real GPU.

The rest of the suite runs on the CPU (the RNG-in-GEMM kernel in the
Pallas interpreter); this file asserts what XLA and Triton compile for
the card against componentwise error bounds (the reference's posture that
every hot kernel is oracle-checked, test_matmul_cores/linop_common.hh:
194-265). Every test carries the ``gpu`` marker and skips unless JAX's
default backend is a GPU; ``python chip_smoke.py`` runs this tier on the
card (``python -m pytest -m gpu tests/test_gpu_hardware.py``).

Precision model: a default-precision f32 product on the GPU runs with
TF32 operands (10 explicit mantissa bits) and f32 accumulation, on every
route (cuBLAS on the staged path, pl.dot in the kernel). Each operand
entry carries a relative input error of at most 2^-10 whatever the
conversion's rounding mode, so the bound is
(2 * 2^-10 + 2 k eps_f32) |S| |A| (oracle.tf32_bound).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _needs_gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend (run through chip_smoke.py)")


def _check_tf32(B, S_block, A):
    from oracle import assert_tf32_close
    assert_tf32_close(np.asarray(B), S_block, A)


@pytest.mark.parametrize("rng", ["philox4x32", "threefry4x32"])
def test_rowmajor_fused_on_hardware(rng):
    import jax.numpy as jnp
    import randblas_tpu as rb
    from randblas_tpu.ops import fused_sketch as fs

    d, m, n = 256, 4096, 512
    S = rb.DenseSkOp(rb.DenseDist(d, m), rb.RNGState.from_key(1, rng=rng))
    A = jnp.asarray(np.random.default_rng(0).normal(
        size=(m, n)).astype(np.float32))
    B = np.asarray(fs.fused_sketch(S, A))
    _check_tf32(B, np.asarray(S.materialize()), np.asarray(A))


def test_rowmajor_fused_submatrix_on_hardware():
    import jax.numpy as jnp
    import randblas_tpu as rb
    from randblas_tpu.ops import fused_sketch as fs

    dist = rb.DenseDist(300, 4500)
    S = rb.DenseSkOp(dist, rb.RNGState.from_key(2))
    rows_s, cols_s, ro, co = 192, 4096, 64, 101  # unaligned co
    A = jnp.asarray(np.random.default_rng(1).normal(
        size=(cols_s, 384)).astype(np.float32))
    B = np.asarray(fs.fused_sketch(S, A, rows_s=rows_s, cols_s=cols_s,
                                   ro_s=ro, co_s=co))
    blk = np.asarray(S.materialize())[ro:ro + rows_s, co:co + cols_s]
    _check_tf32(B, blk, np.asarray(A))


def test_colmajor_fused_on_hardware():
    import jax.numpy as jnp
    import randblas_tpu as rb
    from randblas_tpu.ops import fused_sketch as fs

    d, m, n = 1024, 512, 512   # tall + Long = ColMajor natural
    S = rb.DenseSkOp(rb.DenseDist(d, m), rb.RNGState.from_key(3))
    from randblas_tpu.base import Layout
    from randblas_tpu.dense import dist_to_layout
    assert dist_to_layout(S.dist) == Layout.ColMajor
    A = jnp.asarray(np.random.default_rng(2).normal(
        size=(m, n)).astype(np.float32))
    B = np.asarray(fs.fused_sketch(S, A))
    _check_tf32(B, np.asarray(S.materialize()), np.asarray(A))


def test_blocked_ell_on_hardware():
    import jax.numpy as jnp
    from randblas_tpu.ops.ell_spmm import blocked_ell_matmul
    from randblas_tpu.sparse_data import COOMatrix, ELLMatrix

    m, k, nnz = 2048, 4096, 40_000
    rng = np.random.default_rng(4)
    coo = COOMatrix.from_arrays(
        m, k, rng.integers(0, m, nnz), rng.integers(0, k, nnz),
        rng.normal(size=nnz).astype(np.float32))
    bell = ELLMatrix.from_coo(coo).blocked()
    b = jnp.asarray(rng.normal(size=(k, 256)).astype(np.float32))
    got = np.asarray(blocked_ell_matmul(bell, b))
    dense = np.zeros((m, k), np.float32)
    np.add.at(dense, (np.asarray(coo.rows), np.asarray(coo.cols)),
              np.asarray(coo.vals))
    _check_tf32(got, dense, np.asarray(b))


def test_word_plane_fill_bit_identity_on_hardware():
    """fill_colmajor (word-plane rewrite, round 3) must equal the
    row-major fill's transpose BITWISE on the compiled GPU path — same
    generator rounds and float transforms, only the data movement
    differs (ops/dense_fill.py::fill_colmajor)."""
    import jax.numpy as jnp
    import randblas_tpu as rb
    from randblas_tpu.ops.dense_fill import fill_colmajor, fill_rowmajor

    st = rb.RNGState.from_key(7)
    for transform, (pd, rows, cols, ptr) in [
        ("boxmul", (4096, 512, 1000, 0)),
        ("uneg11", (4096, 512, 1000, 0)),
        ("boxmul", (1030, 200, 515, 2060)),  # odd dims + column offset
    ]:
        got = np.asarray(fill_colmajor(pd, rows, cols, ptr, st, transform))
        want = np.asarray(fill_rowmajor(pd, rows, cols, ptr, st,
                                        transform)).T
        np.testing.assert_array_equal(got, want)


def test_word_major_blocked_ell_on_hardware():
    """The word-major operand-order fast path (sketch_sparse of an
    implicit ColMajor-natural operator through BlockedELL.word_major)
    on the card, against the densify oracle."""
    import jax.numpy as jnp
    import randblas_tpu as rb
    from randblas_tpu.sparse_data import COOMatrix, ELLMatrix

    m, k, nnz = 2048, 4100, 40_000   # k % 4 != 0: phantom storage rows
    rng = np.random.default_rng(6)
    coo = COOMatrix.from_arrays(
        m, k, rng.integers(0, m, nnz), rng.integers(0, k, nnz),
        rng.normal(size=nnz).astype(np.float32))
    bell = ELLMatrix.from_coo(coo).blocked(word_major=4)
    S = rb.DenseSkOp(rb.DenseDist(k, 256), rb.RNGState.from_key(11))
    got = np.asarray(rb.sketch_sparse(S, bell, side="right"))
    dense = np.zeros((m, k), np.float32)
    np.add.at(dense, (np.asarray(coo.rows), np.asarray(coo.cols)),
              np.asarray(coo.vals))
    _check_tf32(got, dense, np.asarray(S.materialize()))


def test_fused_grad_on_hardware():
    """jax.grad through the compiled fused kernel: the cotangent is a
    transposed fused sketch (custom_vjp, ops/fused_sketch.py) — checked
    against the staged-path gradient."""
    import jax.numpy as jnp
    import randblas_tpu as rb
    from randblas_tpu.ops import fused_sketch as fs

    d, m, n = 256, 4096, 512
    S = rb.DenseSkOp(rb.DenseDist(d, m), rb.RNGState.from_key(21))
    A = jnp.asarray(np.random.default_rng(9).normal(
        size=(m, n)).astype(np.float32))
    g = jax.grad(lambda a: jnp.sum(fs.fused_sketch(S, a) ** 2))(A)
    Smat = S.materialize()
    g_ref = jax.grad(lambda a: jnp.sum((Smat @ a) ** 2))(A)
    rel = float(jnp.max(jnp.abs(g - g_ref)) / jnp.max(jnp.abs(g_ref)))
    assert rel < 1e-2, rel


def test_f64_hiprec_on_hardware():
    import jax.numpy as jnp
    from randblas_tpu.ops.f64gemm import matmul_hiprec

    if not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)
    rng = np.random.default_rng(5)
    a = rng.normal(size=(130, 1000))
    b = rng.normal(size=(1000, 77))
    got = np.asarray(matmul_hiprec(jnp.asarray(a), jnp.asarray(b)))
    want = a @ b
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 1e-14


def test_srht_on_hardware():
    """SRHT apply on the chip, two assertions per direction:

    1. precision='highest' (f32-accurate stages) must meet the f32-eps
       componentwise bound — this validates the compiled Kronecker
       staging, the zero-pad, and the sampled-row gather.
    2. the default (production) precision runs each stage at TF32 with
       rounded INTERMEDIATES between stages, so it only promises
       reduced-precision relative accuracy —
       checked as a relative Frobenius bound against the f64 oracle
       (catches gross bugs without over-claiming stage precision)."""
    import jax.numpy as jnp
    import randblas_tpu as rb
    from oracle import assert_componentwise_close

    d, m, n = 512, 6000, 256     # m non-pow2: exercises the zero-pad
    S = rb.TrigSkOp(rb.TrigDist(d, m), rb.RNGState.from_key(3))
    A = jnp.asarray(np.random.default_rng(0).normal(size=(m, n)),
                    jnp.float32)
    y = jnp.asarray(np.random.default_rng(1).normal(size=(d, 8)),
                    jnp.float32)
    s_dense = np.asarray(S.materialize()).astype(np.float64)

    B_hi = np.asarray(jax.jit(
        lambda a: S.lmult(a, precision="highest"))(A))
    assert_componentwise_close(B_hi, s_dense, np.asarray(A),
                               eps=float(np.finfo(np.float32).eps))
    Bt_hi = np.asarray(jax.jit(
        lambda y: S.lmult_t(y, precision="highest"))(y))
    assert_componentwise_close(Bt_hi, s_dense.T, np.asarray(y),
                               eps=float(np.finfo(np.float32).eps))

    for got, want in [
        (np.asarray(jax.jit(lambda a: rb.sketch(S, a))(A)),
         s_dense @ np.asarray(A, np.float64)),
        (np.asarray(jax.jit(lambda y: rb.sketch_general(
            S, y, op_s="T"))(y)),
         s_dense.T @ np.asarray(y, np.float64)),
    ]:
        rel = (np.linalg.norm(got - want)
               / max(np.linalg.norm(want), 1e-30))
        assert rel < 3e-2, rel


def test_saso_onehot_panel_on_hardware():
    """The config-3 production route: a wide canonical SASO through the
    public sketch() dispatches to the GPU's wide-SASO route
    (skge.SASO_ROUTE: one-hot panels contracted with a GEMM,
    ops/coo_apply.py::onehot_panel_apply). Oracle: the densified
    operator under the TF32 componentwise bound."""
    import jax.numpy as jnp
    import randblas_tpu as rb

    d, m, n, k = 512, 16384, 512, 8
    S = rb.SparseSkOp(rb.SparseDist(d, m, vec_nnz=k),
                      rb.RNGState.from_key(31))
    A = jnp.asarray(np.random.default_rng(12).normal(
        size=(m, n)).astype(np.float32))
    got = np.asarray(rb.sketch(S, A))
    _check_tf32(got, np.asarray(S.materialize()), np.asarray(A))


def test_saso_row_gather_on_hardware():
    """Tall canonical SASO -> ops/coo_apply.py::row_gather_apply (pure
    gather + k-term weighted sum, no GEMM): full f32 accuracy, so the
    oracle is the raw f32 densified operator under the componentwise
    bound."""
    import jax.numpy as jnp
    import randblas_tpu as rb
    from oracle import assert_componentwise_close

    d, m, n, k = 4096, 1024, 384, 8
    S = rb.SparseSkOp(rb.SparseDist(d, m, vec_nnz=k),
                      rb.RNGState.from_key(32))
    A = jnp.asarray(np.random.default_rng(13).normal(
        size=(m, n)).astype(np.float32))
    got = np.asarray(rb.sketch(S, A))
    assert_componentwise_close(got, np.asarray(S.materialize()),
                               np.asarray(A),
                               eps=float(np.finfo(np.float32).eps))


def test_coo_flat_scatter_densify_on_hardware():
    """The one-shot flat-scatter traced-COO densify
    (ops/coo_apply.py::coo_left_apply_dense), reached two ways: the auto
    dispatch for a wide operand, and general (non-canonical)
    sparse-operator triplets through the public spmm. Compiled scatter +
    TF32 GEMM vs the densify oracle."""
    import jax.numpy as jnp
    from randblas_tpu.ops.coo_apply import (
        coo_left_apply_auto, coo_left_apply_dense)
    from randblas_tpu.sparse_data import COOMatrix
    from randblas_tpu.sparse_data.spmm import spmm

    d, m, nnz, n = 2048, 8192, 200_000, 512
    rng = np.random.default_rng(14)
    rows = rng.integers(0, d, nnz)
    cols = rng.integers(0, m, nnz)
    vals = rng.normal(size=nnz).astype(np.float32)
    B = jnp.asarray(rng.normal(size=(m, n)).astype(np.float32))
    dense = np.zeros((d, m), np.float32)
    np.add.at(dense, (rows, cols), vals)

    got = np.asarray(coo_left_apply_dense(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
        B, d, m))
    _check_tf32(got, dense, np.asarray(B))
    # the auto dispatch must take the same route at this (wide-n) shape;
    # scatter-add atomics sum duplicates in no fixed order, so the two
    # calls agree to f32 rounding, not bitwise
    got_auto = np.asarray(coo_left_apply_auto(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
        B, d, m))
    np.testing.assert_allclose(got, got_auto, rtol=1e-6,
                               atol=1e-6 * np.abs(got).max())
    # and the public sparse-DATA product rides it too
    got_spmm = np.asarray(spmm(
        COOMatrix.from_arrays(d, m, rows, cols, vals), B))
    _check_tf32(got_spmm, dense, np.asarray(B))


def test_tensor_sketch_on_hardware():
    """tensor_sketch (FFT-domain CountSketch convolution, tensor.py) on
    the compiled GPU path vs the explicit Kronecker-CountSketch oracle:
    densify each factor's CountSketch, form the exact Khatri-Rao product
    sketch in f64 on host, compare in relative Frobenius norm (f32 FFT
    + TF32 factor sketches => ~1e-3)."""
    import jax.numpy as jnp
    from randblas_tpu import RNGState
    from randblas_tpu.tensor import _countsketch, tensor_sketch

    d, m1, m2, n = 256, 96, 80, 16
    rng = np.random.default_rng(15)
    a1 = jnp.asarray(rng.normal(size=(m1, n)).astype(np.float32))
    a2 = jnp.asarray(rng.normal(size=(m2, n)).astype(np.float32))
    st = RNGState.from_key(33)
    out, _ = tensor_sketch([a1, a2], d, st)
    out = np.asarray(out)

    C1 = _countsketch(d, m1, st)
    C2 = _countsketch(d, m2, C1.next_state)
    c1 = np.asarray(C1.materialize()).astype(np.float64)
    c2 = np.asarray(C2.materialize()).astype(np.float64)
    oracle = np.zeros((d, n))
    a1n = np.asarray(a1, np.float64)
    a2n = np.asarray(a2, np.float64)
    # exact CountSketch-of-Kronecker: hash = (h1 + h2) % d, sign = s1*s2,
    # recovered from the densified operators (one nonzero per column)
    r1 = np.abs(c1).argmax(axis=0)
    g1 = c1[r1, np.arange(m1)]
    r2 = np.abs(c2).argmax(axis=0)
    g2 = c2[r2, np.arange(m2)]
    for i1 in range(m1):
        for i2 in range(m2):
            oracle[(r1[i1] + r2[i2]) % d] += (
                g1[i1] * g2[i2] * a1n[i1] * a2n[i2])
    rel = np.linalg.norm(out - oracle) / np.linalg.norm(oracle)
    assert rel < 1e-3, rel


def test_sgmres_pipeline_on_hardware():
    """One composed linalg pipeline on the chip end to end: sketched
    GMRES on a 1k well-conditioned system (Arnoldi matvecs, fused/staged
    sketch of the basis, whitened lstsq) — the true residual must beat
    1e-3 relative."""
    import jax.numpy as jnp
    import randblas_tpu as rb
    from randblas_tpu.linalg import sgmres

    n = 1024
    rng = np.random.default_rng(16)
    a = jnp.asarray((rng.normal(size=(n, n)) / np.sqrt(n)
                     + 4 * np.eye(n)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=n).astype(np.float32))
    x, res_est, _ = sgmres(a, b, rb.RNGState.from_key(34), basis=80)
    x = np.asarray(x, np.float64)
    true_rel = (np.linalg.norm(np.asarray(a, np.float64) @ x
                               - np.asarray(b, np.float64))
                / np.linalg.norm(np.asarray(b)))
    assert true_rel < 1e-3, true_rel
    # the sketched residual estimate must agree within the embedding
    # distortion (~sqrt(m/d) < 1.6 at the default d = 2m + 8)
    assert float(res_est) < 2e-3


def test_single_pass_svd_on_hardware():
    """single_pass_svd (TYUC17, streaming.py) end to end on the chip —
    covers the damped-QR lstsq replacement (qb.qr_clipped_lstsq) in its
    second consumer: recovery of a planted rank-16 spectrum from one
    pass, singular values to 1e-2 relative and reconstruction to the
    noise floor."""
    import jax.numpy as jnp
    from randblas_tpu import RNGState
    from randblas_tpu.linalg import single_pass_svd

    m, n, r = 2048, 512, 16
    rng = np.random.default_rng(17)
    u, _ = np.linalg.qr(rng.normal(size=(m, r)))
    v, _ = np.linalg.qr(rng.normal(size=(n, r)))
    s_true = np.linspace(10.0, 1.0, r)
    a_np = ((u * s_true) @ v.T).astype(np.float32)
    a = jnp.asarray(a_np + 1e-4 * rng.normal(size=(m, n)).astype(
        np.float32))
    uu, ss, vt, _ = single_pass_svd(a, r, RNGState.from_key(35),
                                    oversample=8)
    np.testing.assert_allclose(np.asarray(ss), s_true, rtol=1e-2)
    approx = np.asarray(uu) @ np.diag(np.asarray(ss)) @ np.asarray(vt)
    rel = np.linalg.norm(a_np - approx) / np.linalg.norm(a_np)
    # the one-pass recovery's ALGORITHMIC floor at this (seed,
    # oversample, corange) is 8.587e-3 — the chip must match the CPU
    # oracle's value, which it does to 1e-7 after the round-4
    # Precision.HIGHEST fixes (it sat at 9.7e-3 with default-precision
    # products). Bound = floor + 25% headroom for cross-release drift.
    assert rel < 1.1e-2, rel


def test_rand_geigh_on_hardware():
    """rand_geigh end to end on the chip: Cholesky whitening (two
    n-RHS triangular solves), rangefinder, eigh — recovers a planted
    definite pencil's spectrum. Covers triangular_solve + eigh compiled
    under the suite's x64 mode (probed fine standalone; this pins the
    composed graph)."""
    import jax.numpy as jnp
    from randblas_tpu import RNGState
    from randblas_tpu.linalg import rand_geigh

    n, k = 512, 6
    rng = np.random.default_rng(18)
    g = rng.normal(size=(n, n)).astype(np.float32)
    b = jnp.asarray(g @ g.T / n + np.eye(n, dtype=np.float32))
    ell = np.linalg.cholesky(np.asarray(b, np.float64))
    u, _ = np.linalg.qr(rng.normal(size=(n, k)))
    theta = np.linspace(5.0, -3.0, k)
    a = jnp.asarray((ell @ ((u * theta) @ u.T) @ ell.T).astype(
        np.float32))
    w, x = rand_geigh(a, b, k, RNGState.from_key(36))
    np.testing.assert_allclose(np.sort(np.asarray(w)), np.sort(theta),
                               atol=5e-3)
    xn = np.asarray(x, np.float64)
    bn = np.asarray(b, np.float64)
    np.testing.assert_allclose(xn.T @ bn @ xn, np.eye(k), atol=5e-3)


def test_xtrace_xdiag_on_hardware():
    """XTrace/XDiag on the chip vs exact answers on a controlled
    spectrum. The estimators are cancellation chains of n-length
    contractions (u_i^T A u_i minus projector corrections), exactly
    the pattern a reduced-precision default product corrupts in sgmres
    and one-pass SVD — this pins the Precision.HIGHEST routing end to end
    on compiled code, plus QR + the clipped triangular solve in
    _loo_directions under the suite's x64 mode."""
    import jax.numpy as jnp
    from randblas_tpu import RNGState
    from randblas_tpu.linalg import xdiag, xtrace

    n = 1024
    rng = np.random.default_rng(19)
    u, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = 2.0 ** (-np.arange(n) / 8.0)
    a64 = (u * lam) @ u.T
    a = jnp.asarray(a64.astype(np.float32))
    want_tr = float(lam.sum())
    want_d = np.diag(a64)

    est, se, _ = xtrace(a, n, 96, RNGState.from_key(37))
    assert abs(float(est) - want_tr) < max(6 * float(se),
                                           5e-3 * want_tr)
    d, _ = xdiag(a, n, 96, RNGState.from_key(38))
    err = np.linalg.norm(np.asarray(d) - want_d)
    # 0.047 measured on the CPU oracle at this seed/budget; 0.08 leaves
    # headroom for chip rounding without masking a broken routing
    assert err / np.linalg.norm(want_d) < 0.08


def test_kaczmarz_on_hardware():
    """Block Kaczmarz + block Gauss-Seidel compiled on the chip: pins
    lax.scan over gathered row/column panels + cho_factor/cho_solve
    under the suite's x64 mode, and that the damped-Gram projections
    actually contract on compiled arithmetic (not just in interpret
    mode) — both solvers must recover exact solutions, not plausible
    garbage."""
    import jax.numpy as jnp
    from randblas_tpu import RNGState
    from randblas_tpu.linalg import block_gauss_seidel, block_kaczmarz

    rng = np.random.default_rng(20)
    m, n = 4096, 256
    a = jnp.asarray(rng.standard_normal((m, n)).astype(np.float32))
    xt = rng.standard_normal(n).astype(np.float32)
    b = a @ jnp.asarray(xt)
    x, _ = block_kaczmarz(a, b, RNGState.from_key(39), block=256,
                          steps=30)
    err = np.linalg.norm(np.asarray(x) - xt) / np.linalg.norm(xt)
    assert err < 1e-3

    bn = b + jnp.asarray(rng.standard_normal(m).astype(np.float32))
    xls = np.linalg.lstsq(np.asarray(a, np.float64),
                          np.asarray(bn, np.float64), rcond=None)[0]
    xg, _ = block_gauss_seidel(a, bn, RNGState.from_key(40), block=128,
                               steps=60)
    err = np.linalg.norm(np.asarray(xg) - xls) / np.linalg.norm(xls)
    assert err < 5e-3


def test_rgs_qr_on_hardware():
    """Randomized Gram-Schmidt QR on the chip at a condition number
    where plain CholQR's f32 Gram is numerically singular. Pins the
    HIGHEST routing of the projection GEMMs (the CGS2 passes are
    cancellation chains — reduced-precision products would leave ~4e-3
    residual components in every panel), the (d, b) QR + triangular
    panel solve, and the final CholQR pass on compiled code."""
    import jax.numpy as jnp
    from randblas_tpu import RNGState
    from randblas_tpu.linalg.rgs import rgs_qr

    rng = np.random.default_rng(21)
    m, k = 8192, 128
    u, _ = np.linalg.qr(rng.standard_normal((m, k)))
    v, _ = np.linalg.qr(rng.standard_normal((k, k)))
    s = 3e7 ** (-np.arange(k) / (k - 1))
    a = jnp.asarray(((u * s) @ v.T).astype(np.float32))

    q, r, _ = rgs_qr(a, RNGState.from_key(41), block=64)
    an = np.asarray(a, np.float64)
    qn = np.asarray(q, np.float64)
    rn = np.asarray(r, np.float64)
    rec = np.linalg.norm(qn @ rn - an) / np.linalg.norm(an)
    orth = np.linalg.norm(qn.T @ qn - np.eye(k), 2)
    assert rec < 2e-4, rec
    assert orth < 2e-3, orth
    assert np.allclose(rn, np.triu(rn))


def test_spectral_density_on_hardware():
    """SLQ + KPM density estimation compiled on the chip, pinned
    against ground truth on a CLUSTERED spectrum (VERDICT r4 item 1:
    Gauss-node eigh + Chebyshev three-term recurrences are cancellation
    chains — exactly the class that produced earlier chip-only
    defects). Checks integrated cluster masses (the well-posed
    observable) against exact counts, plus counting normalization."""
    import jax.numpy as jnp
    from randblas_tpu import RNGState
    from randblas_tpu.linalg import eig_count, kpm_density, spectral_density

    rng = np.random.default_rng(22)
    n = 1024
    counts = {-2.0: 200, 0.5: 500, 3.0: 324}
    lam = np.concatenate([c + 0.02 * rng.standard_normal(k)
                          for c, k in counts.items()])
    u, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = jnp.asarray(((u * lam) @ u.T).astype(np.float32))

    grid, dens, _ = spectral_density(a, RNGState.from_key(50),
                                     probes=16, steps=80)
    g = np.asarray(grid, np.float64)
    d = np.asarray(dens, np.float64)
    assert np.all(np.isfinite(d)) and np.all(d > -1e-6)
    total = np.trapezoid(d, g)
    assert abs(total - n) / n < 0.05, total
    for c, k in counts.items():
        mask = (g >= c - 1.0) & (g <= c + 1.0)
        mass = np.trapezoid(np.where(mask, d, 0.0), g)
        assert abs(mass - k) / k < 0.10, (c, mass, k)

    # eig_count on the middle cluster (interval endpoints in gaps)
    cnt, _ = eig_count(a, -0.5, 1.5, RNGState.from_key(51),
                       probes=16, steps=80)
    assert abs(float(cnt) - 500) / 500 < 0.10, float(cnt)

    gridk, densk, _ = kpm_density(a, RNGState.from_key(52), degree=256,
                                  probes=16, npts=801,
                                  bounds=(float(lam.min()) - 0.3,
                                          float(lam.max()) + 0.3))
    gk = np.asarray(gridk, np.float64)
    dk = np.asarray(densk, np.float64)
    assert np.all(np.isfinite(dk))
    totalk = np.trapezoid(dk, gk)
    assert abs(totalk - n) / n < 0.05, totalk
    for c, k in counts.items():
        mask = (gk >= c - 1.0) & (gk <= c + 1.0)
        mass = np.trapezoid(np.where(mask, dk, 0.0), gk)
        assert abs(mass - k) / k < 0.10, (c, mass, k)


def test_frequent_directions_on_hardware():
    """FrequentDirections on the chip: streams a decaying-spectrum
    matrix and checks the GLPW16 data-dependent certificate —
    0 <= ||A^T A - B^T B||_2 <= shrink_mass <= ||A||_F^2/ell — in f64
    on the host (the Gram eigendecomposition shrink
    is an accumulation/cancellation shape with no prior hardware
    coverage)."""
    import jax.numpy as jnp
    from randblas_tpu.linalg import FrequentDirections

    rng = np.random.default_rng(23)
    m, n, ell = 2048, 256, 64
    u = rng.standard_normal((m, n))
    s = 2.0 ** (-np.arange(n) / 16.0)
    a64 = u * s
    a = jnp.asarray(a64.astype(np.float32))

    fd = FrequentDirections(n, ell)
    for i in range(0, m, 160):                 # ragged chunks
        fd.update(a[i:i + 160])
    b = np.asarray(fd.sketch(), np.float64)
    mass = float(fd.shrink_mass)

    gram_err = np.linalg.norm(a64.T @ a64 - b.T @ b, 2)
    fro2 = np.linalg.norm(a64, "fro") ** 2
    # f32 streaming + chip rounding headroom on the lower side; the
    # certificate itself must hold and be meaningfully tighter than
    # the worst-case bound on this decaying spectrum
    assert gram_err <= mass * 1.02 + 1e-3 * fro2, (gram_err, mass)
    assert mass <= fro2 / ell * 1.02, (mass, fro2 / ell)
    assert mass < 0.6 * fro2 / ell, "certificate not tight: " + str(
        (mass, fro2 / ell))


def test_distributed_fd_on_hardware():
    """distributed_fd's shard-local FD scan (lax.scan of Gram-eigh
    shrinks INSIDE shard_map) compiled on a real-GPU Mesh, plus the
    host-side merge: the GLPW16 certificate must hold end to end for
    the full matrix — the mergeable-summary sibling of
    test_frequent_directions_on_hardware."""
    import jax.numpy as jnp
    from randblas_tpu.linalg import distributed_fd
    from randblas_tpu.parallel import make_sketch_mesh

    rng = np.random.default_rng(29)
    m, n, ell = 2048 + 37, 256, 64            # ragged m: padding path
    u = rng.standard_normal((m, n))
    s = 2.0 ** (-np.arange(n) / 16.0)
    a64 = u * s
    a = jnp.asarray(a64.astype(np.float32))
    mesh = make_sketch_mesh(1, 1, jax.devices()[:1])

    fd = distributed_fd(a, ell, mesh)
    b = np.asarray(fd.sketch(), np.float64)
    mass = float(fd.shrink_mass)
    gram_err = np.linalg.norm(a64.T @ a64 - b.T @ b, 2)
    fro2 = np.linalg.norm(a64, "fro") ** 2
    assert gram_err <= mass * 1.02 + 1e-3 * fro2, (gram_err, mass)
    assert mass <= fro2 / ell * 1.02, (mass, fro2 / ell)


def test_shard_map_fused_sketch_on_hardware():
    """The Triton kernel inside shard_map on the card: builds a
    1-device Mesh and drives distributed_sketch's FUSED branch
    (parallel/distributed.py, fs.fused_call inside shard_map), oracle-
    checked against the materialized operator. The CPU dryrun executes
    the same code path in the Pallas interpreter; this proves the
    compile."""
    import jax.numpy as jnp
    import randblas_tpu as rb
    from randblas_tpu.parallel import distributed_sketch, make_sketch_mesh

    d, m, n = 256, 4096, 512
    mesh = make_sketch_mesh(1, 1, jax.devices()[:1])
    S = rb.DenseSkOp(rb.DenseDist(d, m), rb.RNGState.from_key(60))
    A = jnp.asarray(np.random.default_rng(24).normal(
        size=(m, n)).astype(np.float32))
    B = np.asarray(distributed_sketch(S, A, mesh, use_fused=True))
    _check_tf32(B, np.asarray(S.materialize()), np.asarray(A))
    # the auto dispatch (staged at this n) meets the same bound
    B2 = np.asarray(distributed_sketch(S, A, mesh))
    _check_tf32(B2, np.asarray(S.materialize()), np.asarray(A))


def test_distributed_cholqr_rsvd_on_hardware():
    """Sharded CholQR + distributed RSVD compiled on the chip over a
    1-device Mesh: pins NamedSharding-annotated
    factor pipelines (Gram psum + triangular solves + eigh) on a real
    GPU."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from randblas_tpu import RNGState
    from randblas_tpu.linalg.distributed import cholqr, distributed_rsvd
    from randblas_tpu.parallel import make_sketch_mesh

    rng = np.random.default_rng(25)
    mesh = make_sketch_mesh(1, 1, jax.devices()[:1])
    m, n, k = 4096, 384, 16
    u, _ = np.linalg.qr(rng.standard_normal((m, k)))
    v, _ = np.linalg.qr(rng.standard_normal((n, k)))
    s = np.linspace(10.0, 1.0, k)
    a64 = (u * s) @ v.T + 1e-4 * rng.standard_normal((m, n))
    with mesh:
        a = jax.device_put(
            jnp.asarray(a64.astype(np.float32)),
            NamedSharding(mesh, P("data", None)))
        y = jax.device_put(
            jnp.asarray((u * s).astype(np.float32)),
            NamedSharding(mesh, P("data", None)))
        q, r = cholqr(y)
        uu, ss, vt = distributed_rsvd(a, k, RNGState.from_key(61),
                                      mesh, power_iters=1)
    qn = np.asarray(q, np.float64)
    assert np.linalg.norm(qn.T @ qn - np.eye(k), 2) < 1e-4
    np.testing.assert_allclose(qn @ np.asarray(r, np.float64),
                               u * s, rtol=0, atol=5e-3)
    np.testing.assert_allclose(np.asarray(ss)[:k], s, rtol=2e-2)
    rec = (np.asarray(uu, np.float64) * np.asarray(ss, np.float64)) \
        @ np.asarray(vt, np.float64)
    assert np.linalg.norm(rec - a64) / np.linalg.norm(a64) < 2e-2


def test_saso_route_on_hardware():
    """Config-3-shaped wide SASO sketches through the GPU's wide-SASO
    route (skge.SASO_ROUTE["gpu"]) against the TF32 componentwise bound,
    plus ragged d/m/n, plus the same route inside shard_map on a 1-device
    Mesh (parallel/distributed.py::distributed_sparse_sketch)."""
    import jax.numpy as jnp
    import randblas_tpu as rb
    from randblas_tpu.parallel import distributed_sparse_sketch, \
        make_sketch_mesh

    mesh = make_sketch_mesh(1, 1, jax.devices()[:1])
    for d, m, n, k, seed in [(1024, 16384, 512, 8, 70),
                             (1000, 8192, 129, 8, 71)]:
        S = rb.SparseSkOp(rb.SparseDist(d, m, vec_nnz=k),
                          rb.RNGState.from_key(seed))
        A = jnp.asarray(np.random.default_rng(seed).normal(
            size=(m, n)).astype(np.float32))
        dense = np.asarray(S.materialize())
        _check_tf32(rb.sketch_general(S, A), dense, np.asarray(A))
        _check_tf32(distributed_sparse_sketch(S, A, mesh), dense,
                    np.asarray(A))


def test_kfjlt_on_hardware():
    """KFJLT (tensor.py::kfjlt_sketch) on the chip vs the f64
    materialized sampled-Kronecker oracle built from the SAME streams.
    Two assertions (the SRHT posture, which supplies the per-mode
    Hadamards): precision='highest' must sit at f32-eps-level relative
    accuracy; the production default (TF32 stages) at a relative
    Frobenius bound. Also pins structured == explicit ON HARDWARE
    (distinct compiled paths: per-factor transforms vs the mode-lattice
    sweep + multi-index gather)."""
    import jax.numpy as jnp
    from randblas_tpu import RNGState
    from randblas_tpu.ops.hadamard import hadamard_matrix
    from randblas_tpu.tensor import (_kfjlt_sample, kfjlt_scale,
                                     kfjlt_sketch, kfjlt_sketch_explicit)

    d, dims, n = 256, (96, 80), 16      # non-pow2 modes: padding path
    rng = np.random.default_rng(16)
    mats = [jnp.asarray(rng.normal(size=(m, n)).astype(np.float32))
            for m in dims]
    st = RNGState.from_key(34)

    parts, _ = _kfjlt_sample(dims, d, st, jnp.float32)
    rows = None
    for m, (sgn, m_pad, idx) in zip(dims, parts):
        h = np.asarray(hadamard_matrix(m_pad)).astype(np.float64)
        blk = h[np.asarray(idx), :m] * np.asarray(sgn,
                                                  np.float64)[None, :]
        rows = blk if rows is None else \
            (rows[:, :, None] * blk[:, None, :]).reshape(d, -1)
    kr = np.einsum("ik,jk->ijk", np.asarray(mats[0], np.float64),
                   np.asarray(mats[1], np.float64)).reshape(-1, n)
    want = kfjlt_scale(dims, d) * (rows @ kr)
    wn = np.linalg.norm(want)

    hi = np.asarray(jax.jit(lambda ms: kfjlt_sketch(
        ms, d, st, precision="highest")[0])(mats))
    assert np.linalg.norm(hi - want) / wn < 1e-5

    lo = np.asarray(jax.jit(lambda ms: kfjlt_sketch(ms, d, st)[0])(mats))
    assert np.linalg.norm(lo - want) / wn < 3e-2

    big = jnp.asarray(kr.astype(np.float32))
    ex = np.asarray(jax.jit(lambda x: kfjlt_sketch_explicit(
        x, dims, d, st, precision="highest")[0])(big))
    assert np.linalg.norm(ex - want) / wn < 1e-5


def test_tt_round_on_hardware():
    """TT tier (linalg/tt.py) on the chip: tt_from_dense +
    tt_add + tt_round are QR/SVD/einsum cancellation chains — the
    exact class that produced three chip-only defects — so
    pin them against f64 host oracles. Three assertions: exact-rank
    recovery from dense, the add-then-round-back certificate, and
    quasi-optimal truncation vs the f64 TT-SVD baseline."""
    import jax.numpy as jnp
    from randblas_tpu import RNGState
    from randblas_tpu.linalg import (tt_add, tt_from_dense, tt_gaussian,
                                     tt_round, tt_scale)

    x, _ = tt_gaussian((8, 9, 7, 6), (3, 4, 2), RNGState.from_key(1))
    dense = np.asarray(x.full(), np.float64)
    tt2, _ = tt_from_dense(jnp.asarray(dense.astype(np.float32)),
                           (3, 4, 2), RNGState.from_key(2))
    rel = np.linalg.norm(np.asarray(tt2.full(), np.float64) - dense) \
        / np.linalg.norm(dense)
    assert rel < 1e-2, rel            # TF32 stages on the card

    s = tt_add(x, tt_scale(x, 2.0))
    r, _ = tt_round(s, (3, 4, 2), RNGState.from_key(3))
    rel = np.linalg.norm(np.asarray(r.full(), np.float64) - 3 * dense) \
        / (3 * np.linalg.norm(dense))
    assert rel < 1e-2, rel

    # decaying spectrum: truncation error within a small factor of the
    # f64 deterministic TT-SVD (the quasi-optimality certificate)
    rng = np.random.default_rng(8)
    y = np.zeros((9, 10, 11), np.float64)
    for t in range(8):
        a, b, c = (rng.standard_normal(sz) for sz in (9, 10, 11))
        y += (0.5 ** t) * np.einsum("i,j,k->ijk", a, b, c)
    ty, _ = tt_from_dense(jnp.asarray(y.astype(np.float32)), 8,
                          RNGState.from_key(12), power_iters=2)
    ry, _ = tt_round(ty, 3, RNGState.from_key(13), oversample=4)
    got = np.linalg.norm(np.asarray(ry.full(), np.float64) - y)

    import sys as _sys
    _sys.path.insert(0, "tests")
    from test_tt import tt_svd_oracle
    base = np.linalg.norm(tt_svd_oracle(y, 3) - y)
    assert got < 3 * base + 5e-2 * np.linalg.norm(y), (got, base)


def test_tucker_on_hardware():
    """Randomized ST-HOSVD (linalg/tucker.py) on the chip vs the f64
    deterministic ST-HOSVD oracle on a decaying-spectrum tensor
    (rangefinder + safe_svd truncation chains at TF32 stage
    precision)."""
    import jax.numpy as jnp
    from randblas_tpu import RNGState
    from randblas_tpu.linalg import tucker_from_dense, tucker_full

    rng = np.random.default_rng(2)
    y = np.zeros((12, 13, 14), np.float64)
    for t in range(10):
        a, b, c = (rng.standard_normal(sz) for sz in (12, 13, 14))
        y += (0.5 ** t) * np.einsum("i,j,k->ijk", a, b, c)
    cc, ff, _ = tucker_from_dense(jnp.asarray(y.astype(np.float32)), 4,
                                  RNGState.from_key(2), power_iters=2)
    got = np.linalg.norm(
        np.asarray(tucker_full(cc, ff), np.float64) - y)

    import sys as _sys
    _sys.path.insert(0, "tests")
    from test_tucker import st_hosvd_oracle
    base = np.linalg.norm(st_hosvd_oracle(y, 4) - y)
    assert got < 2 * base + 5e-2 * np.linalg.norm(y), (got, base)
    for u in ff:
        g = np.asarray(jnp.matmul(u.T, u))
        np.testing.assert_allclose(g, np.eye(g.shape[0]), atol=2e-2)


def test_ihs_lsq_on_hardware():
    """Iterative Hessian sketch on the chip: pins the heavy-ball scan
    (two triangular solves + two HIGHEST-precision thin products per
    step) on compiled arithmetic under the suite's x64 mode. The
    gradient precision policy is load-bearing — a default-precision gradient
    floors the solution error at ~1e-3, an order above the assertion —
    so this catches any precision regression in qb._mm_precise routing,
    the class of chip-only defect that once bit rgs_qr."""
    import jax.numpy as jnp
    from randblas_tpu import RNGState
    from randblas_tpu.linalg import ihs_lsq

    rng = np.random.default_rng(22)
    m, n = 8192, 256
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = 1e2 ** (-np.arange(n) / (n - 1))
    a = jnp.asarray(((u * s) @ v.T).astype(np.float32))
    xt = rng.standard_normal(n).astype(np.float32)
    b = a @ jnp.asarray(xt) + 1e-4 * jnp.asarray(
        rng.standard_normal(m).astype(np.float32))

    xls = np.linalg.lstsq(np.asarray(a, np.float64),
                          np.asarray(b, np.float64), rcond=None)[0]
    x, _ = ihs_lsq(a, b, RNGState.from_key(42), iters=24)
    err = np.linalg.norm(np.asarray(x) - xls) / np.linalg.norm(xls)
    assert err < 1e-4, err
