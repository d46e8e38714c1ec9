"""Tests for the row/column-action solvers (linalg/kaczmarz.py):
block randomized Kaczmarz and randomized block Gauss-Seidel.

Pins (a) geometric convergence against exact dense answers, (b) the
reproducibility contract (pure function of (A, b, state); next_state
chains), and (c) the damped-Gram robustness edges (duplicate sampled
indices, zero matrices)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import randblas_tpu as rbt
from randblas_tpu.linalg import block_gauss_seidel, block_kaczmarz


def _consistent(m, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n)).astype(np.float32)
    xt = rng.standard_normal(n).astype(np.float32)
    return jnp.asarray(a), jnp.asarray(a @ xt), xt


class TestBlockKaczmarz:

    @pytest.mark.parametrize("sampling", ["rownorm", "uniform"])
    def test_converges_on_consistent_system(self, sampling):
        a, b, xt = _consistent(2000, 200, seed=0)
        x, nxt = block_kaczmarz(a, b, rbt.default_state(1),
                                block=128, steps=40, sampling=sampling)
        err = np.linalg.norm(np.asarray(x) - xt) / np.linalg.norm(xt)
        assert err < 1e-4
        assert nxt.to_dict() != rbt.default_state(1).to_dict()

    def test_geometric_decay(self):
        a, b, xt = _consistent(2000, 200, seed=1)
        errs = []
        for steps in (5, 20, 40):
            x, _ = block_kaczmarz(a, b, rbt.default_state(2),
                                  block=128, steps=steps)
            errs.append(np.linalg.norm(np.asarray(x) - xt))
        assert errs[1] < 0.05 * errs[0]
        assert errs[2] < 0.05 * errs[1]

    def test_reproducible_and_jits(self):
        a, b, _ = _consistent(600, 80, seed=2)
        x1, n1 = block_kaczmarz(a, b, rbt.default_state(3),
                                block=64, steps=10)
        x2, n2 = block_kaczmarz(a, b, rbt.default_state(3),
                                block=64, steps=10)
        np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))
        assert n1.to_dict() == n2.to_dict()
        f = jax.jit(lambda aa, bb: block_kaczmarz(
            aa, bb, rbt.default_state(3), block=64, steps=10)[0])
        np.testing.assert_array_equal(np.asarray(f(a, b)),
                                      np.asarray(x1))

    def test_warm_start_helps(self):
        a, b, xt = _consistent(800, 100, seed=3)
        x5, _ = block_kaczmarz(a, b, rbt.default_state(4),
                               block=64, steps=5)
        xw, _ = block_kaczmarz(a, b, rbt.default_state(5),
                               block=64, steps=5, x0=x5)
        assert (np.linalg.norm(np.asarray(xw) - xt)
                < 0.1 * np.linalg.norm(np.asarray(x5) - xt))

    def test_multiple_rhs(self):
        rng = np.random.default_rng(4)
        a = jnp.asarray(rng.standard_normal((800, 64)).astype(np.float32))
        xt = rng.standard_normal((64, 3)).astype(np.float32)
        b = a @ jnp.asarray(xt)
        x, _ = block_kaczmarz(a, b, rbt.default_state(6),
                              block=64, steps=30)
        assert np.linalg.norm(np.asarray(x) - xt) < 1e-3

    def test_zero_matrix_stays_finite(self):
        a = jnp.zeros((100, 20), jnp.float32)
        b = jnp.zeros((100,), jnp.float32)
        x, _ = block_kaczmarz(a, b, rbt.default_state(7),
                              block=16, steps=5)
        np.testing.assert_array_equal(np.asarray(x), np.zeros(20))

    def test_tiny_block_duplicates_ok(self):
        # block ~ m guarantees duplicate sampled rows inside a block;
        # the damped Gram solve must stay finite and still converge
        a, b, xt = _consistent(64, 16, seed=5)
        x, _ = block_kaczmarz(a, b, rbt.default_state(8),
                              block=64, steps=30)
        assert np.all(np.isfinite(np.asarray(x)))
        assert np.linalg.norm(np.asarray(x) - xt) < 1e-3

    def test_validates(self):
        a, b, _ = _consistent(100, 20, seed=6)
        with pytest.raises(ValueError):
            block_kaczmarz(a, b[:50], rbt.default_state(1))
        with pytest.raises(ValueError):
            block_kaczmarz(a, b, rbt.default_state(1), block=200)
        with pytest.raises(ValueError):
            block_kaczmarz(a, b, rbt.default_state(1), steps=0)
        with pytest.raises(ValueError):
            block_kaczmarz(a, b, rbt.default_state(1), sampling="bogus")


class TestBlockGaussSeidel:

    @pytest.mark.parametrize("sampling", ["colnorm", "uniform"])
    def test_converges_to_least_squares(self, sampling):
        rng = np.random.default_rng(10)
        a = rng.standard_normal((2000, 200)).astype(np.float32)
        b = rng.standard_normal(2000).astype(np.float32)  # inconsistent
        xls = np.linalg.lstsq(a, b, rcond=None)[0]
        x, _ = block_gauss_seidel(jnp.asarray(a), jnp.asarray(b),
                                  rbt.default_state(11), block=64,
                                  steps=60, sampling=sampling)
        err = np.linalg.norm(np.asarray(x) - xls) / np.linalg.norm(xls)
        assert err < 1e-3

    def test_residual_orthogonality(self):
        # at the LS solution, A^T r == 0: the converged iterate must
        # satisfy the normal equations, not just have a small residual
        rng = np.random.default_rng(11)
        a = rng.standard_normal((1000, 100)).astype(np.float32)
        b = rng.standard_normal(1000).astype(np.float32)
        x, _ = block_gauss_seidel(jnp.asarray(a), jnp.asarray(b),
                                  rbt.default_state(12), block=50,
                                  steps=80)
        r = b - a @ np.asarray(x)
        assert np.linalg.norm(a.T @ r) < 1e-2 * np.linalg.norm(
            a.T @ b)

    def test_reproducible_chains_state(self):
        rng = np.random.default_rng(12)
        a = jnp.asarray(rng.standard_normal((400, 60)).astype(np.float32))
        b = jnp.asarray(rng.standard_normal(400).astype(np.float32))
        x1, n1 = block_gauss_seidel(a, b, rbt.default_state(13),
                                    block=30, steps=10)
        x2, n2 = block_gauss_seidel(a, b, rbt.default_state(13),
                                    block=30, steps=10)
        np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))
        assert n1.to_dict() == n2.to_dict()
        assert n1.to_dict() != rbt.default_state(13).to_dict()

    def test_duplicate_columns_in_block_ok(self):
        rng = np.random.default_rng(13)
        a = rng.standard_normal((300, 24)).astype(np.float32)
        xt = rng.standard_normal(24).astype(np.float32)
        b = a @ xt
        x, _ = block_gauss_seidel(jnp.asarray(a), jnp.asarray(b),
                                  rbt.default_state(14), block=24,
                                  steps=40)
        assert np.all(np.isfinite(np.asarray(x)))
        assert np.linalg.norm(np.asarray(x) - xt) < 1e-3

    def test_validates(self):
        rng = np.random.default_rng(14)
        a = jnp.asarray(rng.standard_normal((100, 20)).astype(np.float32))
        b = jnp.asarray(rng.standard_normal(100).astype(np.float32))
        with pytest.raises(ValueError):
            block_gauss_seidel(a, jnp.zeros((100, 2)),
                               rbt.default_state(1))
        with pytest.raises(ValueError):
            block_gauss_seidel(a, b, rbt.default_state(1), block=21)
        with pytest.raises(ValueError):
            block_gauss_seidel(a, b, rbt.default_state(1),
                               sampling="rownorm")


class TestGaussSeidelShuffle:
    """The 'shuffle' sampling mode (default): permuted
    contiguous panels instead of iid index gathers."""

    def test_is_the_default_and_converges(self):
        rng = np.random.default_rng(20)
        a = rng.standard_normal((2000, 200)).astype(np.float32)
        b = rng.standard_normal(2000).astype(np.float32)
        xls = np.linalg.lstsq(a, b, rcond=None)[0]
        x, _ = block_gauss_seidel(jnp.asarray(a), jnp.asarray(b),
                                  rbt.default_state(21), block=64,
                                  steps=60)
        xs, _ = block_gauss_seidel(jnp.asarray(a), jnp.asarray(b),
                                   rbt.default_state(21), block=64,
                                   steps=60, sampling="shuffle")
        np.testing.assert_array_equal(np.asarray(x), np.asarray(xs))
        err = np.linalg.norm(np.asarray(x) - xls) / np.linalg.norm(xls)
        assert err < 1e-4

    def test_nondivisible_block_pads_with_phantoms(self):
        # n=200, block=96 -> two full panels + one padded with 88 zero
        # rows; phantom coordinates must never leak into x
        rng = np.random.default_rng(21)
        a = rng.standard_normal((1500, 200)).astype(np.float32)
        xt = rng.standard_normal(200).astype(np.float32)
        b = a @ xt
        x, _ = block_gauss_seidel(jnp.asarray(a), jnp.asarray(b),
                                  rbt.default_state(22), block=96,
                                  steps=45)
        assert x.shape == (200,)
        assert np.linalg.norm(np.asarray(x) - xt) < 1e-3

    def test_reproducible_and_chains_state(self):
        rng = np.random.default_rng(22)
        a = jnp.asarray(rng.standard_normal((400, 60)).astype(np.float32))
        b = jnp.asarray(rng.standard_normal(400).astype(np.float32))
        x1, n1 = block_gauss_seidel(a, b, rbt.default_state(23),
                                    block=30, steps=10)
        x2, n2 = block_gauss_seidel(a, b, rbt.default_state(23),
                                    block=30, steps=10)
        np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))
        assert n1.to_dict() == n2.to_dict()
        assert n1.to_dict() != rbt.default_state(23).to_dict()

    def test_warm_start(self):
        rng = np.random.default_rng(23)
        a = rng.standard_normal((1000, 100)).astype(np.float32)
        b = rng.standard_normal(1000).astype(np.float32)
        xls = np.linalg.lstsq(a, b, rcond=None)[0]
        x1, _ = block_gauss_seidel(jnp.asarray(a), jnp.asarray(b),
                                   rbt.default_state(24), block=50,
                                   steps=6)
        x2, _ = block_gauss_seidel(jnp.asarray(a), jnp.asarray(b),
                                   rbt.default_state(25), block=50,
                                   steps=6, x0=x1)
        e1 = np.linalg.norm(np.asarray(x1) - xls)
        e2 = np.linalg.norm(np.asarray(x2) - xls)
        assert e2 < 0.2 * e1
