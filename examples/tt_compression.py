"""Tensor-train compression of a discretized multivariate function.

The 4-way Hilbert-like tensor  X[i,j,k,l] = 1 / (1 + i + j + k + l)
(n = 48 per mode, 5.3M entries) has rapidly decaying TT spectrum —
the classic example of a function tensor that is LOW-RANK in the TT
format while having no useful low-rank structure in any single
matricization of moderate aspect ratio.

Pipeline shown:
  1. ``tt_from_dense``: randomized TT-SVD at a rank budget — storage
     drops from n^4 to ~4 n r^2 while the relative error tracks the
     TT spectrum's decay.
  2. TT arithmetic + ``tt_round``: form  Y = X + alpha*X  exactly
     (ranks double), then round back down with the SISC-2023
     Randomize-then-Orthogonalize sweep — the rank-growth-control
     step every TT algorithm (ALS, time-stepping, optimization)
     needs after additions.
  3. Error certificates against the dense truth at this toy size.

The reference library has no tensor tier; this rides its machinery
(counter-addressed Gaussian sketches, HMT rangefinder) one level up.

Run: python examples/tt_compression.py        (on JAX's default device)
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax.numpy as jnp                                        # noqa: E402

from randblas_tpu import RNGState                              # noqa: E402
from randblas_tpu.linalg import (tt_add, tt_from_dense,        # noqa: E402
                                 tt_norm, tt_round, tt_scale)


def main():
    n, p = 48, 4
    idx = np.arange(n)
    grids = np.meshgrid(*([idx] * p), indexing="ij")
    x = (1.0 / (1.0 + sum(grids))).astype(np.float32)
    xj = jnp.asarray(x)
    xn = np.linalg.norm(x)
    print(f"X: {x.shape} = {x.size:,} entries "
          f"({x.nbytes / 2**20:.1f} MiB dense)")

    st = RNGState.from_key(5)
    for rank in (2, 4, 8, 12):
        t0 = time.time()
        tt, st = tt_from_dense(xj, rank, st, power_iters=2)
        dt = time.time() - t0
        err = float(jnp.linalg.norm(tt.full() - xj)) / xn
        store = sum(g.size for g in tt.cores)
        print(f"  rank {rank:3d}: rel err {err:.2e}, "
              f"storage {store:,} ({store / x.size:.2%} of dense, "
              f"{dt:.2f}s)")

    # arithmetic + rounding: Y = 1.5 X with ranks doubled, then rounded
    tt, st = tt_from_dense(xj, 8, st, power_iters=2)
    y = tt_add(tt, tt_scale(tt, 0.5))
    print(f"\ntt_add ranks: {y.ranks} (exact sum, ranks add)")
    r, st = tt_round(y, 8, st)
    err = float(jnp.linalg.norm(r.full() - 1.5 * xj)) / (1.5 * xn)
    print(f"tt_round back to {r.ranks}: rel err {err:.2e}")
    print(f"norm check: tt_norm={float(tt_norm(r)):.4f} "
          f"dense={1.5 * xn:.4f}")
    assert err < 1e-3, "rounding lost the sum"
    print("ok: TT pipeline compresses, adds, and rounds within the "
          "TT spectrum's decay")


if __name__ == "__main__":
    main()
