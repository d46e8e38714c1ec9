"""Sketched GMRES: convergence on nonsymmetric systems, residual
estimate fidelity, sparse/callable parity, truncation behavior, jit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from randblas_tpu.linalg.sgmres import sgmres
from randblas_tpu.rng.state import RNGState
from randblas_tpu.sparse_data.coo import COOMatrix


def _nonsym(n, cond=10.0, seed=0):
    rng = np.random.default_rng(seed)
    # well-conditioned nonsymmetric: identity + scaled random
    a = np.eye(n) + (1.0 / np.sqrt(n)) * rng.standard_normal((n, n))
    return jnp.asarray(a, jnp.float32)


@pytest.mark.slow
def test_full_basis_solves_exactly():
    n = 48
    a = _nonsym(n, seed=1)
    x_true = jnp.asarray(np.random.default_rng(2).standard_normal(n),
                         jnp.float32)
    b = a @ x_true
    x, res, _ = sgmres(a, b, RNGState.from_key(3), basis=n, trunc=6)
    rel = float(jnp.linalg.norm(x - x_true) / jnp.linalg.norm(x_true))
    assert rel < 5e-3
    assert float(res) < 5e-3


@pytest.mark.slow
def test_residual_estimate_tracks_true_residual():
    n = 80
    a = _nonsym(n, seed=4)
    b = jnp.asarray(np.random.default_rng(5).standard_normal(n), jnp.float32)
    x, res, _ = sgmres(a, b, RNGState.from_key(7), basis=24, trunc=4)
    true_rel = float(jnp.linalg.norm(a @ x - b) / jnp.linalg.norm(b))
    # sketched residual within embedding distortion (~sqrt(m/d) ~ 0.7x-1.4x)
    assert 0.4 * true_rel - 1e-6 <= float(res) <= 2.5 * true_rel + 1e-6


@pytest.mark.slow
def test_larger_basis_improves():
    n = 96
    a = _nonsym(n, seed=6)
    b = jnp.asarray(np.random.default_rng(8).standard_normal(n), jnp.float32)
    st = RNGState.from_key(9)
    _, r_small, _ = sgmres(a, b, st, basis=8, trunc=4)
    _, r_big, _ = sgmres(a, b, st, basis=48, trunc=4)
    assert float(r_big) < 0.5 * float(r_small)


@pytest.mark.slow
def test_sparse_and_callable_paths_match_dense():
    n = 64
    rng = np.random.default_rng(10)
    a_np = np.eye(n) + 0.1 * rng.standard_normal((n, n))
    a = jnp.asarray(a_np, jnp.float32)
    b = jnp.asarray(rng.standard_normal(n), jnp.float32)
    st = RNGState.from_key(11)
    x_dense, _, s1 = sgmres(a, b, st, basis=20)
    rows, cols = np.nonzero(a_np)
    coo = COOMatrix.from_arrays(n, n, rows, cols,
                                jnp.asarray(a_np[rows, cols], jnp.float32))
    x_coo, _, s2 = sgmres(coo, b, st, basis=20)
    x_call, _, s3 = sgmres(lambda v: a @ v, b, st, basis=20)
    np.testing.assert_allclose(np.asarray(x_dense), np.asarray(x_call),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(x_dense), np.asarray(x_coo),
                               rtol=0, atol=1e-4)
    assert s1.to_dict() == s2.to_dict() == s3.to_dict()


@pytest.mark.parametrize("operator", ["saso", "gaussian", "srht"])
@pytest.mark.slow
def test_embedding_families(operator):
    n = 72
    a = _nonsym(n, seed=12)
    x_true = jnp.asarray(np.random.default_rng(13).standard_normal(n),
                         jnp.float32)
    b = a @ x_true
    x, res, _ = sgmres(a, b, RNGState.from_key(15), basis=36, trunc=4,
                       operator=operator)
    rel = float(jnp.linalg.norm(x - x_true) / jnp.linalg.norm(x_true))
    assert rel < 0.2, (operator, rel)


@pytest.mark.slow
def test_jit_and_breakdown():
    # b in a 3-dimensional invariant subspace: happy breakdown at j=3;
    # the zero-padded basis must still produce the exact solution.
    n = 40
    lam = jnp.asarray(np.linspace(1.0, 2.0, n), jnp.float32)
    a = jnp.diag(lam)
    b = jnp.zeros(n).at[:3].set(jnp.asarray([1.0, 2.0, 3.0]))
    fn = jax.jit(lambda aa, bb, s: sgmres(aa, bb, s, basis=10, trunc=4)[0])
    x = fn(a, b, RNGState.from_key(17))
    assert bool(jnp.all(jnp.isfinite(x)))
    rel = float(jnp.linalg.norm(a @ x - b) / jnp.linalg.norm(b))
    assert rel < 1e-4


def test_validation():
    a = jnp.eye(8)
    b = jnp.ones((8, 2))
    with pytest.raises(ValueError):
        sgmres(a, b, RNGState.from_key(0))
    with pytest.raises(ValueError):
        sgmres(jnp.ones((8, 4)), jnp.ones(8), RNGState.from_key(0))
    with pytest.raises(ValueError):
        sgmres(a, jnp.ones(8), RNGState.from_key(0), basis=20)


def test_qr_clipped_lstsq_matches_lstsq_and_clips():
    """qr_clipped_lstsq == jnp.linalg.lstsq on full-rank systems; on
    zero/dependent columns it zeroes those coefficients instead of
    pinv-ing (the damped-QR replacement used on the sketched-solve
    paths)."""
    from randblas_tpu.linalg.qb import qr_clipped_lstsq
    rng = np.random.default_rng(9)
    a = jnp.asarray(rng.normal(size=(40, 7)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=40).astype(np.float32))
    want, *_ = jnp.linalg.lstsq(a, b, rcond=None)
    got = qr_clipped_lstsq(a, b)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-5)
    # matrix right-hand side
    B = jnp.asarray(rng.normal(size=(40, 3)).astype(np.float32))
    wantB, *_ = jnp.linalg.lstsq(a, B, rcond=None)
    np.testing.assert_allclose(np.asarray(qr_clipped_lstsq(a, B)),
                               np.asarray(wantB), atol=1e-5)
    # exact zero column (sgmres breakdown padding): the damping drives
    # that coefficient to ~0 while the kept columns still solve their
    # LS problem (the damped system is full-rank, so no 1/~0 division)
    a0 = a.at[:, 3].set(0.0)
    y = np.asarray(qr_clipped_lstsq(a0, b))
    assert abs(y[3]) < 1e-4
    keep = [0, 1, 2, 4, 5, 6]
    yref = np.linalg.lstsq(np.asarray(a0)[:, keep], np.asarray(b),
                           rcond=None)[0]
    np.testing.assert_allclose(y[keep], yref, atol=1e-4)


def test_qr_clipped_lstsq_zero_matrix():
    """Review regression (round 4): an all-zero system must solve to
    y == 0 (lstsq's min-norm answer), not NaN/Inf — the damping floor
    keeps the augmented system full-rank even at ||a|| == 0."""
    from randblas_tpu.linalg.qb import qr_clipped_lstsq
    y = np.asarray(qr_clipped_lstsq(jnp.zeros((10, 3)), jnp.ones(10)))
    np.testing.assert_array_equal(y, np.zeros(3))
