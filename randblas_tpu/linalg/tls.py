"""Total least squares: classical and sketch-and-solve.

Counterpart of the reference's total-least-squares examples
(tls_dense_skop.cc:101-203, tls_sparse_skop.cc): sketch [A b] down to
d ~= 2(n+1) rows, then solve the small TLS problem by SVD.
"""

from __future__ import annotations

from typing import Union

import jax
import jax.numpy as jnp

from ..base import require
from .qb import safe_svd
from ..dense import DenseSkOp
from ..skge import sketch_general
from ..sparse import SparseSkOp


def tls_via_svd(ab: jax.Array) -> jax.Array:
    """Classical TLS on the stacked (m, n+1) matrix [A b]: solution from
    the right singular vector of the smallest singular value
    (tls_dense_skop.cc solver block)."""
    _, _, vt = safe_svd(ab, full_matrices=False)
    v = vt[-1]                      # right singular vector, min sigma
    # x = -v[:n] / v[n]
    return -v[:-1] / v[-1]


def sketched_tls(S: Union[DenseSkOp, SparseSkOp], ab: jax.Array
                 ) -> jax.Array:
    """Sketch-and-solve TLS: compress [A b] with a sketching operator whose
    row count d satisfies n+1 <= d << m, then run classical TLS on the
    sketch (tls_dense_skop.cc:139-186)."""
    m, n1 = ab.shape
    require(S.n_cols == m, "operator width must match data height")
    require(S.n_rows >= n1, "sketch dimension must be at least n+1")
    sab = sketch_general(S, ab)
    return tls_via_svd(sab)
