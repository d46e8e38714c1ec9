"""TensorSketch: oblivious sketching of Khatri–Rao (column-wise
Kronecker) products without forming them.

Pham–Pagh 2013 / Avron–Nguyen–Woodruff 2014: a CountSketch of a
Kronecker product x1 (x) x2 equals the circular convolution of the
factors' individual CountSketches, so

    TS(A1 ⊙ ... ⊙ Ap) = IFFT( prod_i FFT(C_i A_i) )        (per column)

costs O(sum_i nnz(A_i) + d log d * n) instead of the prod_i m_i rows of
the explicit product — the standard embedding for polynomial kernels
(<x, y>^p inner products are preserved in expectation) and for
Kronecker-structured regression.

The CountSketch components C_i ARE this library's sparse sign operators
with vec_nnz=1 (SparseDist's Short-axis draw places exactly one ±1 in a
uniformly random row per column — the CountSketch hash/sign pair), so
each factor's sketch rides the existing lskges dispatch (one-hot GEMM
panels / row gather) and the whole transform is deterministic in the
RNGState and seed-chained across factors. The reference has no tensor
sketching; the counterpart machinery it does have is the SASO family
this is built from (/root/reference/RandBLAS/sparse_skops.hh:134-377).

Accelerator notes: the d-point FFTs run along the sketch axis (n-major
columns); real input rides rfft/irfft so the spectral product is
on d/2+1 complex words. Everything is jittable; for gradients the
factor sketches use the SASO path's exact autodiff.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from .base import MajorAxis, require
from .rng.state import RNGState
from .skge import sketch_general
from .sparse import SparseDist, SparseSkOp
from .util import _uniform_stream_bits, sample_indices_iid_uniform


def _countsketch(d: int, m: int, state: RNGState) -> SparseSkOp:
    """A (d, m) operator with EXACTLY one +-1 per input column — the
    CountSketch hash/sign pair. The major axis must follow the aspect
    ratio: Short places vec_nnz per short-axis vector, which is
    per-column only while d <= m; for d > m (small factors sketched UP)
    the Long/LASO draw (at most vec_nnz per column; exactly one when
    vec_nnz == 1) keeps the per-column structure."""
    major = MajorAxis.Short if d <= m else MajorAxis.Long
    return SparseSkOp(SparseDist(d, m, vec_nnz=1, major_axis=major), state)


def tensor_sketch(factors: Sequence, d: int, state: RNGState, *,
                  dtype=jnp.float32) -> Tuple[jax.Array, RNGState]:
    """Sketch the Khatri–Rao product of ``factors`` down to ``d`` rows.

    ``factors`` is a sequence of (m_i, n) arrays (all sharing the column
    count n); column j of the implicit product is the Kronecker product
    (x)_i factors[i][:, j] with prod_i m_i rows. Returns ``(out,
    next_state)`` with ``out`` (d, n) equal (in distribution, and
    exactly equal to the combined-CountSketch construction — see
    tests/test_tensor_sketch.py) to a CountSketch of the full product:
    unbiased, <TS(x), TS(y)> ~= <x, y> with variance O(1/d).

    A single factor reduces to a plain CountSketch (one ±1 per column
    of the operator). States chain across factors in order, so the
    operator is reproducible from ``state`` alone and ``next_state``
    continues the stream.
    """
    require(len(factors) >= 1, "tensor_sketch needs at least one factor")
    n = factors[0].shape[1]
    for f in factors:
        require(f.ndim == 2 and f.shape[1] == n,
                "factors must be 2-D with a shared column count")
    require(d >= 1, "sketch size d must be >= 1")

    st = state
    spec = None
    for f in factors:
        C = _countsketch(d, f.shape[0], st)
        cf = sketch_general(C, f.astype(dtype))               # (d, n)
        st = C.next_state
        if len(factors) == 1:
            return cf, st
        fhat = jnp.fft.rfft(cf, axis=0)
        spec = fhat if spec is None else spec * fhat
    out = jnp.fft.irfft(spec, n=d, axis=0).astype(dtype)
    return out, st


def _hash_sign(d: int, m: int, state: RNGState):
    """(hash (m,), sign (m,)) of the CountSketch component ``_countsketch``
    builds: the filled COO triplets are minor(= column)-vector-major with
    vec_nnz = 1, so ``rows``/``vals`` in column order ARE the pair —
    holds for both the d <= m (Short) and d > m (Long) draws."""
    s = _countsketch(d, m, state).filled()
    return s.rows, s.vals


def tensor_sketch_explicit(x, mode_dims: Sequence[int], d: int,
                           state: RNGState, *, dtype=jnp.float32
                           ) -> Tuple[jax.Array, RNGState]:
    """S @ x for an EXPLICIT x of shape (prod(mode_dims), n), where S is
    the SAME TensorSketch operator ``tensor_sketch(factors, d, state)``
    applies implicitly to Khatri-Rao-structured input.

    Use this for the unstructured side of a sketched system — e.g.
    randomized CP-ALS (CPRAND, Battaglino-Ballard-Kolda 2018) solves
    ``min || (S Z) A^T - S X_(mode)^T ||`` with Z Khatri-Rao (so
    ``tensor_sketch``) and X_(mode)^T a plain unfolding (so this): the
    two sides MUST see the same operator, which the shared
    ``(mode_dims, d, state)`` guarantees.

    The combined CountSketch is applied directly: hash of Kronecker row
    (i_1..i_p) is ``sum_k h_k(i_k) mod d`` (row-major mode order, first
    factor major — matching jnp.kron and tensor_sketch's convolution),
    sign is the product, and the apply is ONE segment-sum pass over x's
    rows. Returns ``(out (d, n), next_state)`` with ``next_state``
    identical to ``tensor_sketch``'s (the same chained states).
    """
    mode_dims = tuple(int(m) for m in mode_dims)
    require(len(mode_dims) >= 1, "tensor_sketch_explicit needs >= 1 mode")
    require(all(m >= 1 for m in mode_dims), "mode dims must be positive")
    require(d >= 1, "sketch size d must be >= 1")
    total = 1
    for m in mode_dims:
        total *= m
    require(x.ndim == 2 and x.shape[0] == total,
            "x must be 2-D with prod(mode_dims) rows")
    st = state
    h = None
    sgn = None
    for m in mode_dims:
        C = _countsketch(d, m, st).filled()
        hk, sk = C.rows, C.vals
        st = C.next_state
        if h is None:
            h, sgn = hk, sk.astype(dtype)
        else:
            h = (h[:, None] + hk[None, :]).reshape(-1)
            sgn = (sgn[:, None] * sk[None, :].astype(dtype)).reshape(-1)
    h = h % d
    out = jax.ops.segment_sum(sgn[:, None] * x.astype(dtype), h,
                              num_segments=d)
    return out, st


def tensor_sketch_vectors(vectors: Sequence, d: int, state: RNGState, *,
                          dtype=jnp.float32) -> Tuple[jax.Array, RNGState]:
    """tensor_sketch for 1-D factors: sketch of the single Kronecker
    product (x)_i vectors[i]. Returns ``(out (d,), next_state)``."""
    cols = [v[:, None] for v in vectors]
    out, nxt = tensor_sketch(cols, d, state, dtype=dtype)
    return out[:, 0], nxt


def _kfjlt_sample(mode_dims, d: int, state: RNGState, dtype):
    """Per-mode (signs, padded dim, sampled row indices) for a KFJLT,
    chained signs-then-samples per mode (the same stream discipline as
    trig.py/TensorSketch, so next_state = f(dist) holds)."""
    from .ops.hadamard import next_pow2
    st = state
    parts = []
    for m in mode_dims:
        bits, st = _uniform_stream_bits(st, m)
        sgn = jnp.where((bits & jnp.uint32(1)).astype(jnp.bool_),
                        -jnp.ones((m,), dtype), jnp.ones((m,), dtype))
        m_pad = next_pow2(m)
        idx, st = sample_indices_iid_uniform(m_pad, d, st)
        parts.append((sgn, m_pad, idx))
    return parts, st


def kfjlt_scale(mode_dims, d: int) -> float:
    """c with E[(c S)^T (c S)] = I for the UNNORMALIZED per-mode
    Hadamards: per mode, E over a uniform row j of (H D)[j]^T (H D)[j]
    = (1/m_pad) D H^T H D = I, so the uniform sampling already absorbs
    the 1/prod(m_pad) Hadamard normalization (exactly as in SRHT) and
    only the 1/d row-averaging factor remains."""
    import math as _math
    return 1.0 / _math.sqrt(d)


def kfjlt_sketch(factors: Sequence, d: int, state: RNGState, *,
                 dtype=jnp.float32, precision=None
                 ) -> Tuple[jax.Array, RNGState]:
    """Kronecker FJLT (Jin-Kolda-Ward 2020) of the Khatri-Rao product of
    ``factors``: S = c R (H D_1 (x) ... (x) H D_p), with per-mode
    counter-addressed Rademacher D_i, per-mode Walsh-Hadamard H (the
    SRHT machinery, ops/hadamard.py), and R sampling d Kronecker rows
    iid — each coordinate drawn independently per mode, which IS the
    uniform draw over the padded product domain.

    A sampled row of the transformed Kronecker product factorizes into
    the elementwise product of per-mode transformed rows, so the apply
    is p Hadamard transforms + p row gathers + one product — the
    prod(m_i)-row domain is never formed. Compared to ``tensor_sketch``
    the embedding constant has no 3^p growth (TensorSketch's
    second-moment constant), at the cost of O(m_i log m_i) per-mode
    transforms instead of O(nnz); prefer KFJLT for small d budgets /
    many modes, TensorSketch for very sparse factors.

    Returns ``(out (d, n), next_state)``; isometry scale is INCLUDED
    (E[S^T S] = I, see kfjlt_scale). ``precision`` forwards to the
    per-mode Hadamard stage contractions (None = backend default, i.e.
    TF32 on the GPU; pass 'highest' when the sketch is the ONLY
    view of the data kept downstream).
    """
    require(len(factors) >= 1, "kfjlt_sketch needs at least one factor")
    n = factors[0].shape[1]
    for f in factors:
        require(f.ndim == 2 and f.shape[1] == n,
                "factors must be 2-D with a shared column count")
    require(d >= 1, "sketch size d must be >= 1")
    from .ops.hadamard import hadamard_transform
    dims = tuple(f.shape[0] for f in factors)
    parts, nxt = _kfjlt_sample(dims, d, state, dtype)
    out = None
    for f, (sgn, m_pad, idx) in zip(factors, parts):
        x = sgn[:, None] * f.astype(dtype)
        if m_pad != x.shape[0]:
            x = jnp.pad(x, ((0, m_pad - x.shape[0]), (0, 0)))
        y = hadamard_transform(x, precision=precision)[idx, :]   # (d, n)
        out = y if out is None else out * y
    return jnp.asarray(kfjlt_scale(dims, d), dtype) * out, nxt


def kfjlt_sketch_explicit(x, mode_dims: Sequence[int], d: int,
                          state: RNGState, *, dtype=jnp.float32,
                          precision=None) -> Tuple[jax.Array, RNGState]:
    """The SAME KFJLT operator applied to EXPLICIT x of shape
    (prod(mode_dims), n) (row index i_1 * m_2 * ... + ... row-major,
    matching kfjlt_sketch/jnp.kron): reshape x's rows onto the mode
    lattice, run each mode's signed Hadamard along its own axis, then
    gather the d sampled multi-indices. The unstructured-side companion
    of kfjlt_sketch (CPRAND-style solves need both)."""
    mode_dims = tuple(int(m) for m in mode_dims)
    require(len(mode_dims) >= 1, "kfjlt_sketch_explicit needs >= 1 mode")
    total = 1
    for m in mode_dims:
        total *= m
    require(x.ndim == 2 and x.shape[0] == total,
            "x must be 2-D with prod(mode_dims) rows")
    require(d >= 1, "sketch size d must be >= 1")
    from .ops.hadamard import hadamard_transform
    parts, nxt = _kfjlt_sample(mode_dims, d, state, dtype)
    n = x.shape[1]
    z = x.astype(dtype).reshape(*mode_dims, n)
    p = len(mode_dims)
    for ax, (sgn, m_pad, _idx) in enumerate(parts):
        z = jnp.moveaxis(z, ax, 0)
        lead = z.shape[0]
        rest = z.shape[1:]
        flat = sgn[:, None] * z.reshape(lead, -1)
        if m_pad != lead:
            flat = jnp.pad(flat, ((0, m_pad - lead), (0, 0)))
        z = jnp.moveaxis(
            hadamard_transform(flat, precision=precision).reshape(
                m_pad, *rest), 0, ax)
    gather = tuple(idx for (_s, _m, idx) in parts) + (slice(None),)
    out = z[gather]                                          # (d, n)
    return jnp.asarray(kfjlt_scale(mode_dims, d), dtype) * out, nxt


def polynomial_kernel_features(x, degree: int, d: int, state: RNGState, *,
                               dtype=jnp.float32
                               ) -> Tuple[jax.Array, RNGState]:
    """Random features for the homogeneous polynomial kernel
    k(u, v) = <u, v>^degree via TensorSketch of ``degree`` copies of the
    data: z(u) with E[<z(u), z(v)>] = k(u, v).

    ``x`` is (m, n) — n data points as columns (matching the sketching
    convention elsewhere). Returns ``(z (d, n), next_state)``; pair with
    linalg.ridge_lsq on z.T for sketched polynomial kernel regression
    (the kernel matrix is never formed), the polynomial counterpart of
    linalg.random_fourier_features' shift-invariant kernels.
    """
    require(degree >= 1, "degree must be >= 1")
    return tensor_sketch([x] * degree, d, state, dtype=dtype)
