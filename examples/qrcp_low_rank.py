"""Sketch-based QRCP low-rank approximation (reference: examples/
sparse-low-rank-approx/qrcp_matrixmarket.cc:220-283).

Power iteration with sketch-orthogonalize stabilization, then column-
pivoted QR on the small sketch to reveal a rank-k column subset. Reads a
MatrixMarket file if given (like the reference), otherwise generates a
synthetic sparse matrix.

Run: python examples/qrcp_low_rank.py [path.mtx] [k]
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

from randblas_tpu import RNGState                              # noqa: E402
from randblas_tpu.sparse_data import COOMatrix                 # noqa: E402


def load_matrix(path=None):
    if path:
        from scipy.io import mmread
        sp = mmread(path).tocoo()
        return COOMatrix.from_arrays(sp.shape[0], sp.shape[1],
                                     sp.row, sp.col,
                                     sp.data.astype(np.float32))
    # synthetic sparse low-rank: sum of r outer products of sparse vectors
    # plus sparse noise (keeps A sparse AND approximately rank-r)
    rng = np.random.default_rng(0)
    m, n, r, per_vec = 3000, 1200, 12, 40
    dense = np.zeros((m, n), dtype=np.float32)
    for t in range(r):
        u = np.zeros(m, np.float32)
        v = np.zeros(n, np.float32)
        u[rng.choice(m, per_vec, replace=False)] = rng.normal(size=per_vec)
        v[rng.choice(n, per_vec, replace=False)] = rng.normal(size=per_vec)
        dense += (10.0 - 0.5 * t) * np.outer(u, v)
    mask = rng.random(size=(m, n)) < 2e-4
    dense += 0.01 * rng.normal(size=(m, n)).astype(np.float32) * mask
    return COOMatrix.from_dense(dense)


def sketch_qrcp(a: COOMatrix, k: int, power_iters: int = 2):
    """The reference's power-iteration + pivoted-QR pipeline, now a
    library call: randblas_tpu.linalg.sketch_qrcp."""
    from randblas_tpu.linalg import sketch_qrcp as lib_sketch_qrcp
    q, b, piv = lib_sketch_qrcp(a, k, RNGState.from_key(7),
                                power_iters=power_iters)
    return np.asarray(q), np.asarray(b), piv


def stabilizer_study(a: COOMatrix, k: int, power_iters: int = 2):
    """The reference example's stabilization-variant comparison
    (qrcp_matrixmarket.cc:220-283): run the same power iteration with
    each between-pass scheme and compare approximation quality. Expected
    shape of the result: 'qr'/'cholqr' equal within roundoff, 'lu'
    matches them on anything non-pathological at lower cost, 'none'
    degrades once the iteration count squares the spectrum enough that
    un-stabilized columns collapse onto the leading subspace."""
    from randblas_tpu.linalg import sketch_qrcp as lib_sketch_qrcp
    dense = np.asarray(a.to_dense())
    nrm = np.linalg.norm(dense)
    # QUALITY comparison only — no wall clocks (timings live in
    # benchmarks/). The cost ordering is analytic anyway: none < lu
    # (~half a Householder QR) < cholqr < qr.
    print(f"\nstabilizer study (k={k}, power_iters={power_iters}):")
    for stab in ("qr", "cholqr", "lu", "none"):
        q, b, piv = lib_sketch_qrcp(a, k, RNGState.from_key(7),
                                    power_iters=power_iters,
                                    stabilizer=stab)
        rel = np.linalg.norm(dense - np.asarray(q) @ np.asarray(b)) / nrm
        print(f"  {stab:7s}: rel err {rel:.5f}, "
              f"pivots {piv[:4].tolist()}")


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else None
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    a = load_matrix(path)
    print(f"A: {a.n_rows}x{a.n_cols}, nnz={a.nnz}")
    t0 = time.perf_counter()
    q, b, piv = sketch_qrcp(a, k)
    print(f"sketch-QRCP (k={k}): {time.perf_counter() - t0:.3f}s")
    print("leading pivot columns:", piv[:8].tolist())
    # approximation quality: ||A - Q(Q^T A)||_F / ||A||_F
    dense = np.asarray(a.to_dense())
    approx = q @ b
    rel = np.linalg.norm(dense - approx) / np.linalg.norm(dense)
    print(f"rank-{k} relative Frobenius error: {rel:.4f}")
    stabilizer_study(a, k)


if __name__ == "__main__":
    main()
