"""Tensor-train (TT) compression by randomized sketching.

The TT format writes a p-way tensor X (n_1, ..., n_p) as a chain of
3-way cores G_k (r_{k-1}, n_k, r_k) with r_0 = r_p = 1 — the
"matrix-product state" of the tensor world. Storage is sum r n r
instead of prod(n); every algorithm below is a sequence of batched
matmuls over static shapes, so the whole tier jits into GEMMs.

Three entry points, all deterministic in the RNGState with
next_state = f(shape, ranks) (the library-wide stream contract):

- ``tt_gaussian``        random TT with counter-addressed Gaussian
                         cores (the test-matrix / sketching primitive).
- ``tt_from_dense``      randomized TT-SVD of a dense tensor: the
                         successive-unfolding HMT pipeline (Oseledets
                         2011 TT-SVD with each SVD replaced by this
                         library's rangefinder sketch + power
                         iteration).
- ``tt_round``           rank truncation of a TT tensor WITHOUT the
                         classical orthogonalization sweep:
                         Randomize-then-Orthogonalize rounding (Al
                         Daas, Ballard, et al., "Randomized algorithms
                         for rounding in the tensor-train format",
                         SISC 2023) — sketch each left unfolding by
                         contracting against an independent Gaussian
                         TT, so the whole sweep is one pass of small
                         QRs; the 2x-rank additions produced by
                         ``tt_add`` round back down for ~half the
                         classical cost and with no global
                         orthogonalization dependency chain.

Plus the TT algebra the entry points and their tests need: ``tt_add``
(block-diagonal, ranks add), ``tt_scale``, ``tt_dot`` / ``tt_norm``
(interface Gram chains, never densifying), ``TTTensor.full()``.

Reference analog: none — the reference is a matrix-sketching library;
this tier extends its operator families (dense_skops.hh) to the tensor
regime the same way tensor.py's TensorSketch/KFJLT extend them to
Khatri-Rao structure.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from ..base import require
from ..dense import DenseDist, fill_dense
from ..rng.state import RNGState
from .qb import _orth, _stabilize


def _as_ranks(ranks, p: int) -> Tuple[int, ...]:
    """Normalize a rank spec (scalar or length p-1 sequence) to the
    internal length-(p+1) form with the boundary 1s."""
    if isinstance(ranks, int):
        inner = (ranks,) * (p - 1)
    else:
        inner = tuple(int(r) for r in ranks)
        require(len(inner) == p - 1,
                "ranks must be a scalar or length ndim-1")
    require(all(r >= 1 for r in inner), "TT ranks must be >= 1")
    return (1,) + inner + (1,)


@jax.tree_util.register_pytree_node_class
class TTTensor:
    """A tensor in TT format: ``cores[k]`` has shape
    (r_k, n_k, r_{k+1}), r_0 = r_p = 1. Registered as a pytree, so TT
    tensors pass through jit/vmap/scan like any array."""

    def __init__(self, cores: Sequence[jax.Array]):
        cores = list(cores)
        require(len(cores) >= 1, "TTTensor needs at least one core")
        for g in cores:
            require(g.ndim == 3, "TT cores must be 3-D (r_in, n, r_out)")
        require(cores[0].shape[0] == 1 and cores[-1].shape[-1] == 1,
                "boundary TT ranks must be 1")
        for a, b in zip(cores[:-1], cores[1:]):
            require(a.shape[-1] == b.shape[0],
                    "adjacent TT cores must agree on the shared rank")
        self.cores = cores

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(g.shape[1] for g in self.cores)

    @property
    def ranks(self) -> Tuple[int, ...]:
        return tuple(g.shape[0] for g in self.cores) + (1,)

    @property
    def ndim(self) -> int:
        return len(self.cores)

    @property
    def dtype(self):
        return self.cores[0].dtype

    def full(self) -> jax.Array:
        """Contract to the dense (n_1, ..., n_p) tensor (test/oracle
        use; exponential in p by definition)."""
        out = self.cores[0]                       # (1, n_1, r_1)
        for g in self.cores[1:]:
            out = jnp.einsum("a...b,bic->a...ic", out, g)
        return out[0, ..., 0]

    def __repr__(self):
        return (f"TTTensor(shape={self.shape}, ranks={self.ranks}, "
                f"dtype={self.dtype})")

    def tree_flatten(self):
        return tuple(self.cores), len(self.cores)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.cores = list(children)
        return obj


def tt_gaussian(shape: Sequence[int], ranks, state: RNGState, *,
                dtype=jnp.float32) -> Tuple[TTTensor, RNGState]:
    """Random TT tensor with iid N(0,1) cores, filled per core from the
    counter-addressed dense engine (fill order: core k is one
    DenseDist(r_k, n_k * r_{k+1}) sample, cores seed-chained), so the
    draw replays bit-identically on any device and
    next_state = f(shape, ranks)."""
    shape = tuple(int(n) for n in shape)
    require(all(n >= 1 for n in shape), "mode sizes must be >= 1")
    rr = _as_ranks(ranks, len(shape))
    cores = []
    st = state
    for k, n in enumerate(shape):
        r0, r1 = rr[k], rr[k + 1]
        flat, st = fill_dense(DenseDist(r0, n * r1), st, dtype=dtype)
        cores.append(flat.reshape(r0, n, r1))
    return TTTensor(cores), st


def tt_scale(x: TTTensor, alpha) -> TTTensor:
    """alpha * x (absorbed into the first core)."""
    cores = list(x.cores)
    cores[0] = jnp.asarray(alpha, cores[0].dtype) * cores[0]
    return TTTensor(cores)


def tt_add(x: TTTensor, y: TTTensor) -> TTTensor:
    """x + y exactly, with ranks ADDING (the block-diagonal core
    construction; round back down with :func:`tt_round`)."""
    require(x.shape == y.shape, "tt_add needs matching shapes")
    p = x.ndim
    if p == 1:
        return TTTensor([x.cores[0] + y.cores[0]])
    cores = []
    for k in range(p):
        a, b = x.cores[k], y.cores[k]
        if k == 0:
            cores.append(jnp.concatenate([a, b], axis=2))
        elif k == p - 1:
            cores.append(jnp.concatenate([a, b], axis=0))
        else:
            top = jnp.concatenate(
                [a, jnp.zeros((a.shape[0], a.shape[1], b.shape[2]),
                              a.dtype)], axis=2)
            bot = jnp.concatenate(
                [jnp.zeros((b.shape[0], b.shape[1], a.shape[2]),
                           b.dtype), b], axis=2)
            cores.append(jnp.concatenate([top, bot], axis=0))
    return TTTensor(cores)


def tt_dot(x: TTTensor, y: TTTensor) -> jax.Array:
    """<x, y> by the interface Gram chain: carry W_k (r^x_k, r^y_k)
    through one batched contraction per mode — never densifies."""
    require(x.shape == y.shape, "tt_dot needs matching shapes")
    w = jnp.ones((1, 1), x.dtype)
    for gx, gy in zip(x.cores, y.cores):
        # w[a, c] ; gx (a, i, b) ; gy (c, i, d)  ->  (b, d)
        w = jnp.einsum("ac,aib,cid->bd", w, gx, gy,
                       preferred_element_type=x.dtype)
    return w[0, 0]


def tt_norm(x: TTTensor) -> jax.Array:
    """Frobenius norm sqrt(<x, x>)."""
    return jnp.sqrt(jnp.maximum(tt_dot(x, x), 0.0))


def tt_from_dense(x: jax.Array, ranks, state: RNGState, *,
                  oversample: int = 8, power_iters: int = 1,
                  dtype=jnp.float32, orth: str = "cholqr"
                  ) -> Tuple[TTTensor, RNGState]:
    """Randomized TT-SVD of a dense tensor: sweep left to right, and at
    mode k range-find the (r_{k-1} n_k, n_{k+1}...n_p) unfolding of the
    carry with an oversampled Gaussian sketch + ``power_iters`` subspace
    iterations (the HMT recipe of linalg/qb.py applied per unfolding,
    then truncated to r_k through the small factor's SVD). The carry
    shrinks as Q^T @ unfolding, so each later mode works on an already-
    compressed (r n_k, rest) matrix. Returns ``(tt, next_state)``;
    requested ranks are clipped to each unfolding's feasible
    min(rows, cols)."""
    shape = tuple(int(n) for n in x.shape)
    p = len(shape)
    require(p >= 1, "tt_from_dense needs ndim >= 1")
    rr = list(_as_ranks(ranks, p))
    st = state
    cores = []
    carry = x.astype(dtype).reshape(1, -1)        # (r_0 * n_1...n_p)
    r_prev = 1
    for k in range(p - 1):
        n_k = shape[k]
        rest = 1
        for n in shape[k + 1:]:
            rest *= n
        mat = carry.reshape(r_prev * n_k, rest)
        r_k = min(rr[k + 1], mat.shape[0], mat.shape[1])
        rr[k + 1] = r_k
        s = min(r_k + oversample, mat.shape[0], mat.shape[1])
        g, st = fill_dense(DenseDist(mat.shape[1], s), st, dtype=dtype)
        y = jnp.matmul(mat, g, preferred_element_type=dtype)
        for _ in range(power_iters):
            q = _stabilize(y, orth)
            z = jnp.matmul(mat.T, q, preferred_element_type=dtype)
            w = _stabilize(z, orth)
            y = jnp.matmul(mat, w, preferred_element_type=dtype)
        q = _orth(y, orth)                        # (r_prev n_k, s)
        b = jnp.matmul(q.T, mat, preferred_element_type=dtype)
        if s > r_k:                               # truncate via small SVD
            from .qb import safe_svd
            ub, sv, vt = safe_svd(b, full_matrices=False)
            q = jnp.matmul(q, ub[:, :r_k])
            b = sv[:r_k, None] * vt[:r_k, :]
        cores.append(q.reshape(r_prev, n_k, r_k))
        carry = b
        r_prev = r_k
    cores.append(carry.reshape(r_prev, shape[-1], 1))
    return TTTensor(cores), st


def tt_round_deterministic(x: TTTensor, ranks) -> TTTensor:
    """Classical TT rounding (Oseledets 2011): right-to-left
    orthogonalization sweep, then a left-to-right SVD truncation sweep.
    With the tails orthonormal every per-mode truncation is exactly the
    best one in the Frobenius metric. O(p) sequential QRs + SVDs of
    (r n, r) panels — use :func:`tt_round` to skip the
    orthogonalization pass at large ranks; this is both its
    recompression backend and the deterministic baseline."""
    p = x.ndim
    if p == 1:
        return TTTensor(list(x.cores))
    rr = list(_as_ranks(ranks, p))
    # right-to-left: make cores 2..p row-orthonormal (LQ via QR of the
    # transposed right unfolding), absorbing the L factors leftward
    cores = list(x.cores)
    for k in range(p - 1, 0, -1):
        g = cores[k]
        r0, n_k, r1 = g.shape
        mat = g.reshape(r0, n_k * r1)
        q, r = jnp.linalg.qr(mat.T, mode="reduced")   # mat = r.T @ q.T
        cores[k] = q.T.reshape(-1, n_k, r1)
        cores[k - 1] = jnp.einsum("aib,bc->aic", cores[k - 1], r.T,
                                  preferred_element_type=x.dtype)
    # left-to-right: truncate each left unfolding by its SVD (optimal —
    # the tail interface is orthonormal now)
    from .qb import safe_svd
    out = []
    carry = cores[0]
    for k in range(p - 1):
        s_prev, n_k, r1 = carry.shape
        mat = carry.reshape(s_prev * n_k, r1)
        u, sv, vt = safe_svd(mat, full_matrices=False)
        r_k = min(rr[k + 1], u.shape[1])
        out.append(u[:, :r_k].reshape(s_prev, n_k, r_k))
        m = sv[:r_k, None] * vt[:r_k, :]
        carry = jnp.einsum("ab,bic->aic", m, cores[k + 1],
                           preferred_element_type=x.dtype)
    out.append(carry)
    return TTTensor(out)


def tt_round(x: TTTensor, ranks, state: RNGState, *,
             oversample: int = 4, orth: str = "qr"
             ) -> Tuple[TTTensor, RNGState]:
    """Randomize-then-Orthogonalize TT rounding (Al Daas, Ballard, et
    al., "Randomized algorithms for rounding in the tensor-train
    format", SISC 2023): truncate x's ranks to ``ranks`` without the
    classical global orthogonalization sweep over the LARGE input.

    Draw an independent Gaussian TT R at ranks ``r + oversample``
    (:func:`tt_gaussian` — the tensor analog of a dense sketching
    operator), precompute the right interface contractions
    W_k = <tail of x, tail of R> (r^x_k, l_k), then sweep left to
    right: each left unfolding's range is estimated from its SKETCH
    ``unfold @ W_k`` (the paper's key identity: that product equals
    the full matricization times a structured random matrix), and one
    small QR per mode replaces the orthogonalization-plus-SVD of the
    classical algorithm. The oversampled (ranks l) result is then
    recompressed to the target by :func:`tt_round_deterministic` —
    cheap, since it runs at the small sketched ranks; truncating
    inside the sweep instead would pick subspaces in the
    NON-orthonormal tail-interface coordinates and lose the
    quasi-optimality (measured: ~6x the TT-SVD baseline vs <2x for
    this two-stage form). Requested ranks are clipped to each
    unfolding's feasible size. Returns ``(tt, next_state)``;
    next_state = f(shape, ranks) only."""
    p = x.ndim
    shape = x.shape
    if p == 1:
        return TTTensor(list(x.cores)), state
    rr = list(_as_ranks(ranks, p))
    rx = x.ranks
    for k in range(1, p):
        feas_rows = 1
        for i in range(k):
            feas_rows *= shape[i]
        rr[k] = min(rr[k], rx[k], feas_rows)
    ell = [min(rr[k] + oversample, rx[k]) if 0 < k < p else 1
           for k in range(p + 1)]
    r_tt, nxt = tt_gaussian(shape, ell[1:p], state, dtype=x.dtype)

    # right interface chain: w[k] = tail contraction past mode k
    ws = [None] * (p + 1)
    w = jnp.ones((1, 1), x.dtype)
    ws[p] = w
    for k in range(p - 1, 0, -1):
        w = jnp.einsum("aib,cid,bd->ac", x.cores[k], r_tt.cores[k], w,
                       preferred_element_type=x.dtype)
        ws[k] = w                                 # (r^x_k, l_k)

    cores = []
    carry = x.cores[0]                            # (s_{k-1}, n_k, r^x_k)
    for k in range(p - 1):
        s_prev = carry.shape[0]
        n_k = shape[k]
        unfold = carry.reshape(s_prev * n_k, -1)  # (s n, r^x_{k+1})
        sk = jnp.matmul(unfold, ws[k + 1],
                        preferred_element_type=x.dtype)
        q = _orth(sk, orth)                       # (s n, min(sn, l_k))
        m = jnp.matmul(q.T, unfold, preferred_element_type=x.dtype)
        cores.append(q.reshape(s_prev, n_k, -1))
        carry = jnp.einsum("ab,bic->aic", m, x.cores[k + 1],
                           preferred_element_type=x.dtype)
    cores.append(carry)
    return tt_round_deterministic(TTTensor(cores), rr[1:p]), nxt


@jax.tree_util.register_pytree_node_class
class TTMatrix:
    """A linear operator in TT-matrix (MPO) format: ``cores[k]`` has
    shape (R_k, n_out_k, n_in_k, R_{k+1}), R_0 = R_p = 1, acting on
    TT (or vectorized dense) tensors with mode sizes n_in. The
    matrix it represents is the mode-wise Kronecker-structured
    ``full()`` below, with row index row-major over out modes and
    column index row-major over in modes (matching TTTensor.full()
    + reshape(-1))."""

    def __init__(self, cores: Sequence[jax.Array]):
        cores = list(cores)
        require(len(cores) >= 1, "TTMatrix needs at least one core")
        for g in cores:
            require(g.ndim == 4,
                    "TT-matrix cores must be 4-D (R_in, n_out, n_in, "
                    "R_out)")
        require(cores[0].shape[0] == 1 and cores[-1].shape[-1] == 1,
                "boundary TT-matrix ranks must be 1")
        for a, b in zip(cores[:-1], cores[1:]):
            require(a.shape[-1] == b.shape[0],
                    "adjacent TT-matrix cores must agree on the shared "
                    "rank")
        self.cores = cores

    @property
    def out_shape(self) -> Tuple[int, ...]:
        return tuple(g.shape[1] for g in self.cores)

    @property
    def in_shape(self) -> Tuple[int, ...]:
        return tuple(g.shape[2] for g in self.cores)

    @property
    def ranks(self) -> Tuple[int, ...]:
        return tuple(g.shape[0] for g in self.cores) + (1,)

    @property
    def ndim(self) -> int:
        return len(self.cores)

    @property
    def dtype(self):
        return self.cores[0].dtype

    def full(self) -> jax.Array:
        """Contract to the dense (prod n_out, prod n_in) matrix
        (test/oracle use)."""
        out = self.cores[0]                  # (1, o_1, i_1, R_1)
        for g in self.cores[1:]:
            out = jnp.einsum("a...b,boic->a...oic", out, g)
        out = out[0, ..., 0]                 # (o_1, i_1, o_2, i_2, ...)
        p = len(self.cores)
        perm = tuple(range(0, 2 * p, 2)) + tuple(range(1, 2 * p, 2))
        m = 1
        for n in self.out_shape:
            m *= n
        return jnp.transpose(out, perm).reshape(m, -1)

    def __repr__(self):
        return (f"TTMatrix(out={self.out_shape}, in={self.in_shape}, "
                f"ranks={self.ranks}, dtype={self.dtype})")

    def tree_flatten(self):
        return tuple(self.cores), len(self.cores)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.cores = list(children)
        return obj


def tt_matrix_gaussian(out_shape: Sequence[int], in_shape: Sequence[int],
                       ranks, state: RNGState, *, dtype=jnp.float32
                       ) -> Tuple[TTMatrix, RNGState]:
    """Random TT-matrix with iid N(0,1) cores from the counter-addressed
    dense engine (core k = one DenseDist(R_k, o_k * i_k * R_{k+1})
    sample, seed-chained); next_state = f(shapes, ranks)."""
    out_shape = tuple(int(n) for n in out_shape)
    in_shape = tuple(int(n) for n in in_shape)
    require(len(out_shape) == len(in_shape) and len(out_shape) >= 1,
            "out_shape and in_shape must have the same length >= 1")
    rr = _as_ranks(ranks, len(out_shape))
    cores = []
    st = state
    for k, (o, i) in enumerate(zip(out_shape, in_shape)):
        r0, r1 = rr[k], rr[k + 1]
        flat, st = fill_dense(DenseDist(r0, o * i * r1), st, dtype=dtype)
        cores.append(flat.reshape(r0, o, i, r1))
    return TTMatrix(cores), st


def tt_matvec(a: TTMatrix, x: TTTensor, *, ranks=None,
              state: RNGState = None, oversample: int = 4):
    """y = A @ x with A in TT-matrix format and x in TT format: the
    exact product has per-interface ranks R_k * r_k (each product core
    is one batched einsum), the rank-growth event every TT algorithm
    must control. With ``ranks`` given the product is immediately
    truncated — through :func:`tt_round` when ``state`` is provided
    (returns ``(y, next_state)``), else through
    :func:`tt_round_deterministic` (returns ``y``) — so the
    full-rank intermediate exists only core-by-core."""
    require(a.in_shape == x.shape,
            "TT-matrix in_shape must equal the TT vector's shape")
    cores = []
    for g, v in zip(a.cores, x.cores):
        # g (R0, o, i, R1) ; v (r0, i, r1) -> (R0 r0, o, R1 r1)
        c = jnp.einsum("aoib,cid->acobd", g, v,
                       preferred_element_type=x.dtype)
        s = c.shape
        cores.append(c.reshape(s[0] * s[1], s[2], s[3] * s[4]))
    y = TTTensor(cores)
    if ranks is None:
        require(state is None,
                "state without ranks: nothing to round")
        return y
    if state is not None:
        return tt_round(y, ranks, state, oversample=oversample)
    return tt_round_deterministic(y, ranks)


def _stta_ranks(shape, ranks):
    """Clip target ranks to each interface's feasible size."""
    p = len(shape)
    rr = list(_as_ranks(ranks, p))
    for k in range(1, p):
        lead = 1
        for n in shape[:k]:
            lead *= n
        tail = 1
        for n in shape[k:]:
            tail *= n
        rr[k] = min(rr[k], lead, tail)
    return rr


def _stta_sketch(x, r_tt: TTTensor, l_tt: TTTensor, dtype):
    """The STTA sketch family Psi_k = Theta_{k-1} x Omega_k
    (l_{k-1}, n_k, r_k), k = 1..p — LINEAR in x (sketches of additive
    updates add). One left sweep with L's heads plus short right
    chains with R's tails; every contraction a batched matmul."""
    p = x.ndim

    def right_chain(t, k):
        if k == p:
            return t[..., None]               # r_p = 1
        for j in range(p, k, -1):
            g = r_tt.cores[j - 1]             # (r_{j-1}, n_j, r_j)
            if j == p:
                t = jnp.einsum("...i,aib->...ab", t, g,
                               preferred_element_type=dtype)[..., 0]
            else:
                t = jnp.einsum("...ib,aib->...a", t, g,
                               preferred_element_type=dtype)
        return t

    psis = []
    f = x.astype(dtype)[None]                 # (l_0 = 1, n_1, ..., n_p)
    for k in range(1, p + 1):
        psis.append(right_chain(f, k))        # (l_{k-1}, n_k, r_k)
        if k < p:
            f = jnp.einsum("lj...,ljm->m...", f, l_tt.cores[k - 1],
                           preferred_element_type=dtype)
    return psis


def _stta_recover(psis, r_tt: TTTensor, dtype) -> TTTensor:
    """x-free core recovery G_k = Phi_{k-1}^+ Psi_k, with
    Phi_{k-1} = Psi_k contracted against R's core k (so the Phi family
    never needs separate storage) through the damped clipped-QR
    least squares."""
    from .qb import qr_clipped_lstsq
    cores = [psis[0]]                         # l_0 = 1: core as-is
    for k in range(2, len(psis) + 1):
        psi = psis[k - 1]
        phi = jnp.einsum("ljb,ajb->la", psi, r_tt.cores[k - 1],
                         preferred_element_type=dtype)
        l_prev, n_k, r_k = psi.shape
        g = qr_clipped_lstsq(phi, psi.reshape(l_prev, n_k * r_k))
        cores.append(g.reshape(-1, n_k, r_k))
    return TTTensor(cores)


def tt_single_pass(x: jax.Array, ranks, state: RNGState, *,
                   oversample: int = 4, dtype=jnp.float32
                   ) -> Tuple[TTTensor, RNGState]:
    """Streaming two-sided TT approximation (STTA, Kressner-
    Vandereycken-Voorhaar 2022): a TT approximation of x from sketches
    that are LINEAR in x — the TT analog of linalg/streaming.py's
    TYUC17 ``single_pass_svd``.

    Draw two independent Gaussian TTs (:func:`tt_gaussian`): R at the
    target ranks r_k (its tails are the right sketches Omega_k) and L
    at r_k + ``oversample`` (its heads are the left sketches
    Theta_k). The only access to x is through the sketch tensors

        Psi_k = Theta_{k-1} x Omega_k    (l_{k-1}, n_k, r_k)
        Phi_k = Theta_k     x Omega_k    (l_k, r_k)

    and cores are recovered x-free as G_k = Phi_{k-1}^+ Psi_k (the
    oversampled rows make the solve well-posed, KVV22 thm 3.2). For
    tensors that ARRIVE as additive updates, accumulate with
    :class:`TTStream` instead — same sketches, deferred recovery.

    Unlike :func:`tt_from_dense` (two-sided passes + power iteration)
    the result is single-pass quasi-optimal with a larger constant —
    prefer it only when revisiting x is the cost that matters.
    Returns ``(tt, next_state)``; next_state = f(shape, ranks)."""
    shape = tuple(int(n) for n in x.shape)
    require(len(shape) >= 1, "tt_single_pass needs ndim >= 1")
    rr = _stta_ranks(shape, ranks)
    r_tt, st = tt_gaussian(shape, rr[1:-1], state, dtype=dtype)
    l_tt, st = tt_gaussian(shape, [r + oversample for r in rr[1:-1]],
                           st, dtype=dtype)
    psis = _stta_sketch(x, r_tt, l_tt, dtype)
    return _stta_recover(psis, r_tt, dtype), st


class TTStream:
    """Streaming TT accumulator over ADDITIVE updates (x = sum of
    deltas arriving in any order/chunking): keeps only the linear STTA
    sketch family Psi_k — sum(r l n r) numbers — never x. The TT
    sibling of linalg/streaming.py's :class:`StreamingSketch`, with
    the same contract: ``update`` per arrival, ``recover`` at any
    point (recovery does not consume the stream). Deterministic in the
    RNGState; ``next_state`` on the instance chains like every
    operator."""

    def __init__(self, shape, ranks, state: RNGState, *,
                 oversample: int = 4, dtype=jnp.float32):
        self.shape = tuple(int(n) for n in shape)
        require(len(self.shape) >= 1, "TTStream needs ndim >= 1")
        rr = _stta_ranks(self.shape, ranks)
        self._dtype = dtype
        self._r_tt, st = tt_gaussian(self.shape, rr[1:-1], state,
                                     dtype=dtype)
        self._l_tt, st = tt_gaussian(
            self.shape, [r + oversample for r in rr[1:-1]], st,
            dtype=dtype)
        self.next_state = st
        self._psis = None

    def update(self, delta: jax.Array) -> "TTStream":
        require(tuple(delta.shape) == self.shape,
                "update shape must match the stream's shape")
        psis = _stta_sketch(delta, self._r_tt, self._l_tt, self._dtype)
        if self._psis is None:
            self._psis = psis
        else:
            self._psis = [a + b for a, b in zip(self._psis, psis)]
        return self

    def recover(self) -> TTTensor:
        require(self._psis is not None,
                "recover() before any update()")
        return _stta_recover(self._psis, self._r_tt, self._dtype)
