"""Low-rank SVD of a MatrixMarket-file sparse matrix via power iteration.

End-to-end counterpart of the reference's sparse-low-rank-approx examples
(qrcp_matrixmarket.cc:220-283, svd_matrixmarket.cc): load a .mtx file into
a fixed-width sparse container (ELL), run a power-iteration rangefinder
with a choice of stabilization method (LU / QR / sketch-orthogonalize /
none — the same menu as the reference's StabilizationMethod enum), then a
QB -> SVD finish. Prints per-stage timings (TIMED_LINE analog) and
compares the stabilizers' achieved accuracy.

Run:  python examples/svd_matrixmarket.py [--cpu] [path/to/file.mtx]
A demo matrix (rank ~20 plus noise) is generated next to this script on
first use if no path is given. Needs scipy (for MatrixMarket parsing).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if "--cpu" in sys.argv:
    import jax
    jax.config.update("jax_platforms", "cpu")

import jax
import jax.numpy as jnp
import numpy as np

import randblas_tpu as rb
from randblas_tpu.io import load_matrix_market, save_matrix_market
from randblas_tpu.sparse_data import left_spmm, right_spmm

DATA = os.path.join(os.path.dirname(__file__), "data")


def demo_mtx(path, m=2000, n=1500, rank=20, density=0.05, seed=0):
    """Sparse matrix with genuine low-rank structure: a product of sparse
    factors (rank <= `rank`, decaying spectrum) plus faint sparse noise —
    the same flavor as the reference demo's rank-1-plus-noise data
    (svd_rank1_plus_noise.cc)."""
    rng = np.random.default_rng(seed)
    u = (rng.normal(size=(m, rank)) *
         (rng.random(size=(m, rank)) < density)).astype(np.float32)
    v = (rng.normal(size=(rank, n)) *
         (rng.random(size=(rank, n)) < density)).astype(np.float32)
    low = (u * (0.7 ** np.arange(rank))) @ v
    noise = (1e-5 * rng.normal(size=(m, n)) *
             (rng.random(size=(m, n)) < 0.001)).astype(np.float32)
    dense = low + noise
    os.makedirs(os.path.dirname(path), exist_ok=True)
    from randblas_tpu.sparse_data import COOMatrix
    save_matrix_market(path, COOMatrix.from_dense(jnp.asarray(dense)))
    return path


def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    jax.tree_util.tree_map(
        lambda x: x.block_until_ready() if hasattr(x, "block_until_ready")
        else x, out)
    print(f"  {name:<22s}: {time.perf_counter() - t0:8.4f} s")
    return out


# -- stabilizers (qrcp_matrixmarket.cc lu_row_stabilize /
#    qr_row_stabilize / sketch_orthogonalize_rows), functional -------------

def stab_qr(y, _key):
    """Row-orthonormalize via QR of y^T (Householder LQ analog)."""
    q, _ = jnp.linalg.qr(y.T)
    return q.T


def stab_lu(y, _key):
    """LU row stabilization: U rows of the LU factorization, scaled to
    unit diagonal (lu_row_stabilize)."""
    import jax.scipy.linalg as jsl
    _, _, u = jsl.lu(y)
    k = y.shape[0]
    u = u[:k]
    d = jnp.diagonal(u)[:, None]
    return u / jnp.where(jnp.abs(d) > 0, d, 1.0)


def stab_sketch(y, key):
    """Sketch-orthogonalize rows: LQ of a sketched row space, then
    triangular solve (sketch_orthogonalize_rows)."""
    import jax.scipy.linalg as jsl
    k, n = y.shape
    d_s = int(1.25 * k + 1)
    S = rb.DenseSkOp(rb.DenseDist(n, d_s), rb.RNGState.from_key(key))
    m_sk = rb.sketch_general(S, y, side="right")        # (k, d_s)
    q, r = jnp.linalg.qr(m_sk.T)                        # m_sk = r^T q^T
    return jsl.solve_triangular(r.T, y, lower=True)


STABILIZERS = {"qr": stab_qr, "lu": stab_lu, "sketch": stab_sketch,
               "none": lambda y, _k: y}


def power_iter_row_sketch(A, k, p, state, stabilizer="qr"):
    """Y = S A with p data-aware passes over A, row-stabilized between
    passes (power_iter_col_sketch, qrcp_matrixmarket.cc:220-283)."""
    stab = STABILIZERS[stabilizer]
    m, n = A.shape
    S = rb.DenseSkOp(rb.DenseDist(k, m), state)
    y = timed("sample+first spmm",
              lambda: rb.sketch_sparse(S, A, side="left"))   # (k, n)
    for i in range(p):
        y = timed(f"stabilize[{stabilizer}]", stab, y, i)
        # alternate row spaces: y A^T (k, m) then back (k, n)
        z = timed("spmm (y A^T)", lambda: left_spmm(A, y.T).T)
        z = stab(z, 2 * i + 1)
        y = timed("spmm (z A)", lambda: right_spmm(z, A))
    return y


def qb_svd(A, k, p, state, stabilizer="qr"):
    y = power_iter_row_sketch(A, k, p, state, stabilizer)    # (k, n)
    q, _ = timed("orth(Y^T)", jnp.linalg.qr, y.T)            # (n, k)
    b = timed("B = A Q", lambda: left_spmm(A, q))            # (m, k)
    ub, s, vt = timed("svd(B)", jnp.linalg.svd, b)
    return ub[:, :k], s[:k], (vt[:k] @ q.T)


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    path = args[0] if args else demo_mtx(
        os.path.join(DATA, "sparse_rank20.mtx"))
    print(f"loading {path} (device: {jax.devices()[0].platform})")
    A = load_matrix_market(path, format="ell")   # ELL: fixed-width rows
    print(f"A: {A.shape[0]}x{A.shape[1]}, nnz={A.nnz}")
    dense = np.asarray(A.to_dense())
    norm = np.linalg.norm(dense)
    k, p = 32, 2

    for stab in ("qr", "lu", "sketch", "none"):
        print(f"stabilizer = {stab}")
        t0 = time.perf_counter()
        u, s, vt = qb_svd(A, k, p, rb.RNGState.from_key(7), stab)
        total = time.perf_counter() - t0
        err = np.linalg.norm(
            dense - np.asarray(u) * np.asarray(s) @ np.asarray(vt)) / norm
        print(f"  total {total:.4f} s; rel fro error of rank-{k} "
              f"approx: {err:.3e}")

    sv = np.linalg.svd(dense, compute_uv=False)
    best = np.sqrt((sv[k:] ** 2).sum()) / norm
    print(f"optimal rank-{k} rel error (exact SVD): {best:.3e}")


if __name__ == "__main__":
    main()
