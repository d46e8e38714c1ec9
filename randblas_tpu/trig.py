"""SRHT: subsampled randomized Hadamard transform sketching operators.

A beyond-parity operator family (RandBLAS ships dense and sparse-sign
operators only; trig operators are on its roadmap in RandLAPACK). The
operator is

    S = R H D,   S in R^{d x m}

with D = diag(+-1) counter-addressed Rademacher signs, H the
(unnormalized, +-1) Walsh–Hadamard transform of order m_pad =
next_pow2(m), and R a uniform iid row sampler (with replacement,
matching sample_indices_iid_uniform / util.hh:310-334). Applying S to
(m, n) data costs O(m n log m) flops — independent of d — versus
O(d m n) for a dense Gaussian sketch, while giving the same
subspace-embedding guarantees up to log factors.

Framework contracts preserved:
  * entries are a pure function of (dist, seed_state): the sign stream
    consumes ceil(m / len_c) counter blocks starting at the seed, then
    the row sampler consumes ceil(d / len_c) more (reference-exact
    sample_indices_iid_uniform stream, including its discarded first
    block);
  * next_state = f(dist) only, so TrigSkOps chain with every other
    operator family (updates.rst semantics);
  * isometry scale: E[(c S)^T (c S)] = I at c = 1/sqrt(d).

Unlike Dense/SparseSkOp there is NO submatrix counter addressing
(ro_s/co_s): H mixes every input row into every output row, so a
submatrix of S is not a cheaper object — sketch_general rejects nonzero
offsets for this family. Distributed note: an m-sharded Hadamard needs
inter-device butterflies; shard over data COLUMNS (n) instead, where the
transform is embarrassingly parallel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp

from .base import require
from .ops.hadamard import hadamard_transform, next_pow2
from .rng.state import RNGState
from .util import _uniform_stream_bits, sample_indices_iid_uniform


@dataclasses.dataclass(frozen=True)
class TrigDist:
    """Distribution over d x m SRHT operators."""
    n_rows: int   # d: sketch dimension
    n_cols: int   # m: data dimension (rows of the data being sketched)

    def __post_init__(self):
        require(self.n_rows > 0 and self.n_cols > 0,
                "TrigDist dimensions must be positive")

    @property
    def padded_cols(self) -> int:
        return next_pow2(self.n_cols)


def trig_isometry_scale(dist: TrigDist) -> float:
    """c with E[(c S)^T (c S)] = I. For a sampled row r of H D,
    E[h_r h_r^T] = (1/m_pad) (H D)^T (H D) = I, and S^T S sums d such
    draws, so E[S^T S] = d I and c = d^-1/2 (same as Gaussian)."""
    return 1.0 / math.sqrt(dist.n_rows)


def compute_next_state(dist: TrigDist, state: RNGState) -> RNGState:
    """Counter arithmetic only: signs then row samples (see module doc)."""
    len_c = state.len_c
    sign_blocks = -(-dist.n_cols // len_c)
    sample_blocks = -(-dist.n_rows // len_c)
    return state.incr(sign_blocks + sample_blocks)


@jax.tree_util.register_pytree_node_class
class TrigSkOp:
    """A sample from a TrigDist. Lazy: signs/indices generate on demand
    (and cache when not tracing, mirroring DenseSkOp.materialize)."""

    def __init__(self, dist: TrigDist, seed_state: RNGState, *,
                 next_state: Optional[RNGState] = None,
                 signs: Optional[jax.Array] = None,
                 indices: Optional[jax.Array] = None,
                 dtype=jnp.float32):
        if isinstance(seed_state, int):
            seed_state = RNGState.from_key(seed_state)
        self.dist = dist
        self.seed_state = seed_state
        self.next_state = (next_state if next_state is not None
                           else compute_next_state(dist, seed_state))
        self.dtype = jnp.dtype(dtype)
        self._signs = signs
        self._indices = indices

    # -- structure -----------------------------------------------------------

    @property
    def n_rows(self) -> int:
        return self.dist.n_rows

    @property
    def n_cols(self) -> int:
        return self.dist.n_cols

    @property
    def shape(self):
        return (self.dist.n_rows, self.dist.n_cols)

    def _sample(self):
        """(signs (m,), indices (d,)): the operator's entire randomness."""
        if self._signs is not None and self._indices is not None:
            return self._signs, self._indices
        m, d = self.dist.n_cols, self.dist.n_rows
        bits, after_signs = _uniform_stream_bits(self.seed_state, m)
        signs = jnp.where(
            (bits & jnp.uint32(1)).astype(jnp.bool_),
            -jnp.ones((m,), self.dtype), jnp.ones((m,), self.dtype))
        indices, _ = sample_indices_iid_uniform(self.dist.padded_cols, d,
                                                after_signs)
        if not (isinstance(signs, jax.core.Tracer)
                or isinstance(indices, jax.core.Tracer)):
            self._signs, self._indices = signs, indices
        return signs, indices

    # -- application ---------------------------------------------------------

    def lmult(self, a: jax.Array, precision=None) -> jax.Array:
        """S @ a for a of shape (m, n): sign-flip, pad to m_pad, Hadamard,
        subsample d rows."""
        require(a.ndim == 2 and a.shape[0] == self.n_cols,
                "lmult needs a with shape (n_cols, n)")
        signs, indices = self._sample()
        x = signs[:, None].astype(a.dtype) * a
        m_pad = self.dist.padded_cols
        if m_pad != self.n_cols:
            x = jnp.pad(x, ((0, m_pad - self.n_cols), (0, 0)))
        return hadamard_transform(x, precision=precision)[indices, :]

    def lmult_t(self, b: jax.Array, precision=None) -> jax.Array:
        """S^T @ b for b of shape (d, n): the exact adjoint of lmult
        (H is symmetric): scatter rows, Hadamard, truncate, sign-flip."""
        require(b.ndim == 2 and b.shape[0] == self.n_rows,
                "lmult_t needs b with shape (n_rows, n)")
        signs, indices = self._sample()
        m_pad = self.dist.padded_cols
        y = jnp.zeros((m_pad, b.shape[1]), b.dtype)
        y = y.at[indices, :].add(b)
        z = hadamard_transform(y, precision=precision)[:self.n_cols, :]
        return signs[:, None].astype(b.dtype) * z

    def materialize(self) -> jax.Array:
        """Dense (d, m) array of this operator (tests/debug)."""
        return self.lmult(jnp.eye(self.n_cols, dtype=self.dtype))

    # -- pytree protocol -------------------------------------------------------

    def tree_flatten(self):
        children = (self.seed_state, self.next_state, self._signs,
                    self._indices)
        aux = (self.dist, self.dtype)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        dist, dtype = aux
        seed_state, next_state, signs, indices = children
        obj = object.__new__(cls)
        obj.dist = dist
        obj.seed_state = seed_state
        obj.next_state = next_state
        obj.dtype = dtype
        obj._signs = signs
        obj._indices = indices
        return obj

    def __repr__(self):
        return (f"TrigSkOp({self.dist.n_rows}x{self.dist.n_cols}, "
                f"m_pad={self.dist.padded_cols}, dtype={self.dtype})")


def srht_operator(d: int, m: int, key: int = 0, dtype=jnp.float32
                  ) -> TrigSkOp:
    """Convenience: SRHT operator from an integer key."""
    return TrigSkOp(TrigDist(d, m), RNGState.from_key(key), dtype=dtype)
