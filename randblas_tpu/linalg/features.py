"""Random Fourier features (Rahimi-Recht 2007) on the sketching core.

The feature map z(x) = sqrt(2/D) * cos(W x + b) with W ~ N(0, 1/sigma^2)
satisfies E[z(x)^T z(y)] = exp(-||x - y||^2 / (2 sigma^2)) — the RBF
kernel — so kernel methods become LINEAR methods on D features: kernel
ridge regression at n = millions runs as ridge_lsq on an (n, D) feature
matrix instead of an n x n kernel solve.

The W X^T product IS a sketch — it rides sketch_general's dispatch (on
the GPU the Gaussian frequency matrix can be generated inside the
RNG-in-GEMM kernel from counters, never materialized), and the phases b come from the Uniform stream of the
SAME seed-chained state machinery as every operator. The reference has
no feature tier; this is the canonical ML consumer of its primitives.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..base import require
from ..dense import DenseDist, DenseDistName, DenseSkOp
from ..rng.state import RNGState
from ..skge import sketch_general


def random_fourier_features(x, n_features: int, bandwidth: float,
                            state: RNGState, *, dtype=jnp.float32
                            ) -> Tuple[jax.Array, RNGState]:
    """RBF-kernel feature map: ``z`` (n, D) with
    ``z(x_i)^T z(x_j) ~= exp(-||x_i - x_j||^2 / (2 bandwidth^2))``.

    ``x`` is (n, d) data; ``n_features`` = D trades approximation error
    (~1/sqrt(D) uniformly, Rahimi-Recht thm 1) for compute. Frequencies
    ride the fused/staged sketch dispatch; phases consume the chained
    Uniform stream. Returns ``(z, next_state)`` — reproducible and
    chainable like every operator.
    """
    require(x.ndim == 2, "x must be (n_samples, n_dims)")
    require(n_features >= 1, "n_features must be >= 1")
    require(bandwidth > 0, "bandwidth must be > 0")
    n, d = x.shape
    W = DenseSkOp(DenseDist(n_features, d), state, dtype=dtype)
    # W x^T scaled by 1/bandwidth: alpha rides the GEMM epilogue
    proj = sketch_general(W, x.astype(dtype).T,
                          alpha=1.0 / bandwidth).T        # (n, D)
    B = DenseSkOp(DenseDist(1, n_features,
                            family=DenseDistName.Uniform),
                  W.next_state, dtype=dtype)
    # phases uniform on [0, 2*pi): Uniform is uneg11 * sqrt(3)
    b = (B.materialize()[0] / jnp.sqrt(jnp.asarray(3.0, dtype)) * 0.5
         + 0.5) * (2.0 * jnp.pi)
    z = jnp.sqrt(jnp.asarray(2.0 / n_features, dtype)) * jnp.cos(proj + b)
    return z, B.next_state
