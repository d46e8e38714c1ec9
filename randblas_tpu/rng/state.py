"""RNGState: the serializable snapshot of a counter-based RNG stream.

Counterpart of ``RandBLAS::RNGState<RNG>`` (base.hh:161-251).
A state is a tiny pytree of two uint32 arrays (counter, key) plus the
generator name as static metadata, so it can be:

- passed through jit / pjit / shard_map boundaries,
- stored in a checkpoint (it IS the complete resumable state of a sketch
  stream — the reference has no file-based checkpointing, its logical
  checkpoint is exactly this object, see SURVEY.md §5),
- advanced by pure counter arithmetic (``incr``) with no RNG calls.

The counter is read as a little-endian base-2^32 integer, matching the
Random123 ``ctr.incr`` carry semantics pinned in the reference's
test/test_basic_rng/test_r123.cc:686-766.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from . import philox, threefry
from .bits import add64_split, ctr_add64

# generator name -> (ctr_words, key_words, fn, rounds)
_GENERATORS = {
    "philox4x32": (4, 2, philox.philox4x32, 10),
    "philox2x32": (2, 1, philox.philox2x32, 10),
    "threefry4x32": (4, 4, threefry.threefry4x32, 20),
    "threefry2x32": (2, 2, threefry.threefry2x32, 20),
}

# 64-bit-counter generators (the reference's native-f64 stream surface,
# random_gen.hh:121-173). They need 64-bit integer arithmetic, so these
# generate on the HOST (rng/x64.py numpy + native C++ engine; both
# KAT-verified). State storage stays uint32: counter/key arrays hold the
# little-endian LIMB view of the uint64 words (word i -> limbs 2i, 2i+1),
# which makes rng/bits.py::ctr_add64's base-2^32 carry chain bitwise
# equal to Random123's ctr.incr over the uint64 words — incr/incr_key
# work unchanged. Registry values: (ctr_limbs, key_limbs, None, rounds);
# fn is None because there is no traced (JAX) block generator.
_GENERATORS_X64 = {
    "philox4x64": (8, 4, None, 10),
    "philox2x64": (4, 2, None, 10),
    "threefry4x64": (8, 8, None, 20),
    "threefry2x64": (4, 4, None, 20),
}

DEFAULT_RNG = "philox4x32"
DEFAULT_RNG_X64 = "philox4x64"


def generator_info(name: str):
    try:
        return _GENERATORS[name]
    except KeyError:
        try:
            return _GENERATORS_X64[name]
        except KeyError:
            raise ValueError(
                f"unknown counter-based RNG {name!r}; supported: "
                f"{sorted(_GENERATORS) + sorted(_GENERATORS_X64)}"
            ) from None


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RNGState:
    """Counter + key snapshot of a counter-based RNG (default Philox4x32).

    Construct from a seed key with ``RNGState(key=...)`` helpers below, or
    directly from arrays. Immutable and hashable-by-identity like any pytree.
    """

    counter: jax.Array  # uint32[len_c]
    key: jax.Array      # uint32[len_k]
    rng: str = dataclasses.field(default=DEFAULT_RNG, metadata={"static": True})

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_key(key_scalar: int = 0, rng: str = DEFAULT_RNG) -> "RNGState":
        """Counter all-zero; key *word* 0 = key_scalar, rest zero.

        Mirrors ``RNGState(key_uint k)`` (base.hh:205). For x64
        generators the key word is 64-bit, stored as two uint32 limbs.
        """
        len_c, len_k, _, _ = generator_info(rng)
        counter = jnp.zeros((len_c,), dtype=jnp.uint32)
        key = jnp.zeros((len_k,), dtype=jnp.uint32).at[0].set(
            jnp.uint32(key_scalar & 0xFFFFFFFF))
        if rng in _GENERATORS_X64:
            key = key.at[1].set(jnp.uint32((key_scalar >> 32) & 0xFFFFFFFF))
        return RNGState(counter, key, rng)

    @staticmethod
    def from_arrays(counter, key, rng: str = DEFAULT_RNG) -> "RNGState":
        len_c, len_k, _, _ = generator_info(rng)
        counter = jnp.asarray(counter, dtype=jnp.uint32)
        key = jnp.asarray(key, dtype=jnp.uint32)
        if counter.shape != (len_c,):
            raise ValueError(f"counter must have shape ({len_c},) for {rng}")
        if key.shape != (len_k,):
            raise ValueError(f"key must have shape ({len_k},) for {rng}")
        return RNGState(counter, key, rng)

    # -- info --------------------------------------------------------------

    @property
    def len_c(self) -> int:
        return generator_info(self.rng)[0]

    @property
    def len_k(self) -> int:
        return generator_info(self.rng)[1]

    @property
    def is_x64(self) -> bool:
        """True for 64-bit-counter generators (host-side, f64 streams)."""
        return self.rng in _GENERATORS_X64

    @property
    def block_width(self) -> int:
        """Values generated per counter block — the reference's
        ``ctr_size`` (CTR::static_size): counter WORDS, not uint32
        limbs. All counter-addressing math (padding, strides,
        next_state) uses this, so x32 and x64 streams share one set of
        submatrix/update semantics."""
        return self.len_c // 2 if self.is_x64 else self.len_c

    @property
    def generate(self) -> Callable:
        """The raw block generator: (ctr[...,W], key) -> uint32[...,W].

        x64 states have no traced generator (they need 64-bit integer
        arithmetic); use rng.x64's numpy functions or the native engine.
        """
        _, _, fn, rounds = generator_info(self.rng)
        if fn is None:
            raise ValueError(
                f"{self.rng} has no traced (JAX) block generator; the "
                "x64 CBRNGs are host-side — use randblas_tpu.rng.x64 "
                "or the native engine")
        return lambda ctr, key: fn(ctr, key, rounds)

    # -- counter arithmetic --------------------------------------------------

    def incr(self, amount=1) -> "RNGState":
        """Advance the counter by ``amount`` (a python int < 2**64, or a
        traced uint32 scalar). Pure counter arithmetic: no RNG invocations.
        Counterpart of Random123 ``ctr.incr(n)``.
        """
        if isinstance(amount, (int, np.integer)):
            lo, hi = add64_split(amount)
        else:
            lo, hi = amount, 0
        return RNGState(ctr_add64(self.counter, lo, hi), self.key, self.rng)

    def incr_key(self, amount=1) -> "RNGState":
        """Advance the *key* array (same little-endian semantics).

        Counterpart of ``state.key.incr(step)`` (base.hh:185-188), used to
        derive statistically-independent streams.
        """
        if isinstance(amount, (int, np.integer)):
            lo, hi = add64_split(amount)
        else:
            lo, hi = amount, 0
        if self.len_k == 1:
            new_key = self.key.at[0].add(jnp.uint32(lo))
        else:
            new_key = ctr_add64(self.key, lo, hi)
        return RNGState(self.counter, new_key, self.rng)

    # -- checkpoint / resume ---------------------------------------------

    def to_dict(self) -> dict:
        """Plain-python snapshot: the COMPLETE resumable state of a sketch
        stream (the reference's logical checkpoint, SURVEY.md §5). Stable
        across versions; json/msgpack-safe."""
        return {
            "rng": self.rng,
            "counter": [int(w) for w in np.asarray(
                jax.device_get(self.counter))],
            "key": [int(w) for w in np.asarray(jax.device_get(self.key))],
        }

    @staticmethod
    def from_dict(d: dict) -> "RNGState":
        return RNGState.from_arrays(
            np.asarray(d["counter"], dtype=np.uint32),
            np.asarray(d["key"], dtype=np.uint32), d["rng"])

    # -- convenience ---------------------------------------------------------

    def counter_as_int(self) -> int:
        """Host-side read of the counter as one big integer (for tests)."""
        words = np.asarray(jax.device_get(self.counter), dtype=np.uint64)
        return int(sum(int(w) << (32 * i) for i, w in enumerate(words)))

    def __repr__(self) -> str:  # mirrors operator<< (base.hh:234-251)
        c = np.asarray(jax.device_get(self.counter))
        k = np.asarray(jax.device_get(self.key))
        return f"RNGState<{self.rng}>(counter={c.tolist()}, key={k.tolist()})"


def default_state(key: int = 0, rng: str = DEFAULT_RNG) -> RNGState:
    return RNGState.from_key(key, rng)
