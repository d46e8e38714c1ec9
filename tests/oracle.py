"""Serial numpy oracle for the counter-addressed streams.

An intentionally-naive, loop-structured reimplementation of the sampling
algorithms (following the published algorithm definitions and the semantics
documented in SURVEY.md), used to cross-check the vectorized JAX library.
Keeping this oracle serial and separate guards the library's vectorized
index math against self-consistent-but-wrong bugs.
"""

from __future__ import annotations

import numpy as np

M4_0 = np.uint32(0xD2511F53)
M4_1 = np.uint32(0xCD9E8D57)
W_0 = np.uint32(0x9E3779B9)
W_1 = np.uint32(0xBB67AE85)


def _mulhilo(a, b):
    p = int(a) * int(b)
    return np.uint32(p >> 32), np.uint32(p & 0xFFFFFFFF)


def philox4x32_once(ctr, key, rounds=10):
    x = [np.uint32(c) for c in ctr]
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    with np.errstate(over="ignore"):
        for r in range(rounds):
            if r > 0:
                k0 = np.uint32((int(k0) + int(W_0)) & 0xFFFFFFFF)
                k1 = np.uint32((int(k1) + int(W_1)) & 0xFFFFFFFF)
            hi0, lo0 = _mulhilo(M4_0, x[0])
            hi1, lo1 = _mulhilo(M4_1, x[2])
            x = [hi1 ^ x[1] ^ k0, lo1, hi0 ^ x[3] ^ k1, lo0]
    return x


def ctr_incr(ctr, n):
    """128-bit little-endian add on a 4-word uint32 counter."""
    total = sum(int(w) << (32 * i) for i, w in enumerate(ctr)) + int(n)
    total &= (1 << (32 * len(ctr))) - 1
    return [np.uint32((total >> (32 * i)) & 0xFFFFFFFF)
            for i in range(len(ctr))]


def u01_f32(u):
    return np.float32(np.float32(np.uint32(u)) * np.float32(2.0 ** -32)
                      + np.float32(2.0 ** -33))


def uneg11_f32(u):
    s = np.int32(np.uint32(u).view(np.int32) if isinstance(u, np.uint32)
                 else np.uint32(u).astype(np.int64) - (1 << 32)
                 if int(u) >= (1 << 31) else int(u))
    return np.float32(np.float32(s) * np.float32(2.0 ** -31)
                      + np.float32(2.0 ** -32))


def boxmul_f32(u0, u1):
    ang = np.float32(np.float32(3.1415926535897932) * uneg11_f32(u0))
    r = np.float32(np.sqrt(np.float32(-2.0) * np.log(u01_f32(u1))))
    return np.float32(np.sin(ang) * r), np.float32(np.cos(ang) * r)


def block_values(ctr, key, family):
    """One Philox4x32 block -> 4 float32 values."""
    rv = philox4x32_once(ctr, key)
    if family == "gaussian":
        v0, v1 = boxmul_f32(rv[0], rv[1])
        v2, v3 = boxmul_f32(rv[2], rv[3])
        return [v0, v1, v2, v3]
    return [uneg11_f32(v) for v in rv]


def fill_rowmajor_oracle(n_cols_parent, n_srows, n_scols, ptr, ctr, key,
                         family):
    """Serial row-by-row fill, mirroring fill_dense_submat_impl's walk."""
    ctr_size = 4
    pad = (-n_cols_parent) % ctr_size
    ptr_padded = ptr + (ptr // n_cols_parent) * pad
    ctr_mat_start = ptr_padded // ctr_size
    fbs = ptr_padded % ctr_size
    stride = (n_cols_parent + pad) // ctr_size
    base = ctr_incr(ctr, ctr_mat_start)
    out = np.zeros((n_srows, n_scols), dtype=np.float32)
    for row in range(n_srows):
        c_row = ctr_incr(base, row * stride)
        vals = []
        nblk = (fbs + n_scols - 1) // ctr_size + 1
        for b in range(nblk):
            vals.extend(block_values(ctr_incr(c_row, b), key, family))
        out[row] = vals[fbs:fbs + n_scols]
    return out


def componentwise_bound(lhs, rhs, alpha, beta, b0, eps):
    """Per-entry error-bound matrix for B = alpha*lhs@rhs + beta*b0.

    Port of the reference's componentwise comparator semantics
    (test_matmul_cores/linop_common.hh:194-265):

        E = (|alpha| * k * 2eps) * |lhs| @ |rhs| + (|beta| * eps) * |b0|

    where k is the contraction length — the standard forward-error bound
    of a k-term dot product, doubled to cover the oracle's own rounding.
    eps is the epsilon of the precision the computation actually ran in.
    """
    lhs = np.abs(np.asarray(lhs, dtype=np.float64))
    rhs = np.abs(np.asarray(rhs, dtype=np.float64))
    k = lhs.shape[1]
    bound = (abs(alpha) * k * 2 * eps) * (lhs @ rhs)
    if b0 is not None and beta:
        bound = bound + abs(beta) * eps * np.abs(
            np.asarray(b0, dtype=np.float64))
    return bound


def assert_componentwise_close(actual, lhs, rhs, *, alpha=1.0, beta=0.0,
                               b0=None, eps=None):
    """Check actual == alpha*lhs@rhs + beta*b0 within the componentwise
    error-bound matrix (comparison.hh:157-179 buffs_approx_equal with
    bounds). The expected value is computed in float64; `eps` defaults to
    the epsilon of actual's dtype (the precision of the library path)."""
    actual = np.asarray(actual)
    if eps is None:
        eps = float(np.finfo(actual.dtype).eps)
    lhs64 = np.asarray(lhs, dtype=np.float64)
    rhs64 = np.asarray(rhs, dtype=np.float64)
    expect = alpha * (lhs64 @ rhs64)
    if b0 is not None and beta:
        expect = expect + beta * np.asarray(b0, dtype=np.float64)
    bound = componentwise_bound(lhs, rhs, alpha, beta, b0, eps)
    err = np.abs(actual.astype(np.float64) - expect)
    bad = err > bound
    if bad.any():
        i, j = np.unravel_index(np.argmax(err - bound), err.shape)
        raise AssertionError(
            f"componentwise bound violated at ({i},{j}): "
            f"|{actual[i, j]} - {expect[i, j]}| = {err[i, j]:.3e} > "
            f"{bound[i, j]:.3e} ({int(bad.sum())}/{bad.size} entries)")


# TF32 keeps 10 explicit mantissa bits: converting an f32 operand to it
# moves each entry by less than 2^-10 of its magnitude, whichever
# rounding mode the conversion uses.
TF32_INPUT_REL = 2.0 ** -10


def tf32_bound(lhs, rhs):
    """Per-entry error bound of lhs @ rhs computed with TF32 operands and
    f32 accumulation: (2 * 2^-10 + 2 k eps_f32) * |lhs| @ |rhs| — both
    operands' input rounding plus the componentwise accumulation bound
    (componentwise_bound's doubled k*eps convention)."""
    lhs = np.abs(np.asarray(lhs, dtype=np.float64))
    rhs = np.abs(np.asarray(rhs, dtype=np.float64))
    k = lhs.shape[1]
    eps = float(np.finfo(np.float32).eps)
    return (2 * TF32_INPUT_REL + 2 * k * eps) * (lhs @ rhs)


def assert_tf32_close(actual, lhs, rhs):
    """Check actual == lhs @ rhs within tf32_bound (expected value in
    float64)."""
    actual = np.asarray(actual, dtype=np.float64)
    expect = np.asarray(lhs, np.float64) @ np.asarray(rhs, np.float64)
    bound = tf32_bound(lhs, rhs)
    err = np.abs(actual - expect)
    bad = err > bound
    if bad.any():
        i, j = np.unravel_index(np.argmax(err - bound), err.shape)
        raise AssertionError(
            f"TF32 bound violated at ({i},{j}): |{actual[i, j]} - "
            f"{expect[i, j]}| = {err[i, j]:.3e} > {bound[i, j]:.3e} "
            f"({int(bad.sum())}/{bad.size} entries)")


def fisher_yates_oracle(ctr, key, vec_nnz, dim_major, dim_minor):
    """Serial repeated Fisher-Yates with an explicit work vector and the
    restore step, mirroring the documented sampler semantics."""
    idxs = np.zeros((dim_minor, vec_nnz), dtype=np.int64)
    vals = np.zeros((dim_minor, vec_nnz), dtype=np.float32)
    vec_work = list(range(dim_major))
    for i in range(dim_minor):
        pivots = []
        c = ctr_incr(ctr, i * vec_nnz)
        for j in range(vec_nnz):
            rv = philox4x32_once(c, key)
            ell = j + int(rv[0]) % (dim_major - j)
            pivots.append(ell)
            swap = vec_work[ell]
            vec_work[ell] = vec_work[j]
            vec_work[j] = swap
            idxs[i, j] = swap
            vals[i, j] = 1.0 if int(rv[1]) % 2 == 0 else -1.0
            c = ctr_incr(c, 1)
        for j in range(vec_nnz, 0, -1):
            jj = j - 1
            swap = idxs[i, jj]
            ell = pivots[jj]
            vec_work[jj] = vec_work[ell]
            vec_work[ell] = swap
    return idxs, vals
