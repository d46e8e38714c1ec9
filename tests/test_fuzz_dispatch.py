"""Randomized sweep over the sketch_general dispatch lattice.

Draws random configurations (side, ops, operator kind/family/major-axis,
submatrix offsets, scalars, dtypes) with a fixed seed and checks every
one against the densify oracle. Guards the seams between the materialize,
fused-eligible, sparse fast-path, and fallback branches.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from randblas_tpu import (
    DenseDist, DenseDistName, DenseSkOp, MajorAxis, RNGState, SparseDist,
    SparseSkOp, sketch_general,
)

RNG = np.random.default_rng(20260816)


def _random_config(i):
    rng = np.random.default_rng(1000 + i)
    side = rng.choice(["left", "right"])
    op_s = rng.choice(["N", "T"])
    op_a = rng.choice(["N", "T"])
    d = int(rng.integers(1, 12))
    m = int(rng.integers(2, 40))
    n = int(rng.integers(1, 9))
    ro = int(rng.integers(0, 3))
    co = int(rng.integers(0, 3))
    alpha = float(rng.choice([1.0, -1.0, 0.5, 2.0, 0.0]))
    beta = float(rng.choice([0.0, 1.0, -0.5]))
    kind = rng.choice(["gauss", "unif", "saso", "laso"])
    dtype = np.float32 if rng.random() < 0.8 else np.float64
    return dict(side=side, op_s=op_s, op_a=op_a, d=d, m=m, n=n, ro=ro,
                co=co, alpha=alpha, beta=beta, kind=kind, dtype=dtype,
                seed=int(rng.integers(0, 1000)))


def _make_operator(cfg):
    # stored operator shape: for left, op_s(block) must be (d, m); block
    # is dims_before_op(d, m, op_s); add offsets for headroom
    if cfg["side"] == "left":
        blk = (cfg["d"], cfg["m"]) if cfg["op_s"] == "N" \
            else (cfg["m"], cfg["d"])
    else:
        blk = (cfg["m"], cfg["d"]) if cfg["op_s"] == "N" \
            else (cfg["d"], cfg["m"])
    rows = blk[0] + cfg["ro"]
    cols = blk[1] + cfg["co"]
    state = RNGState.from_key(cfg["seed"])
    if cfg["kind"] in ("gauss", "unif"):
        fam = (DenseDistName.Gaussian if cfg["kind"] == "gauss"
               else DenseDistName.Uniform)
        ma = MajorAxis.Long if cfg["seed"] % 2 else MajorAxis.Short
        return DenseSkOp(DenseDist(rows, cols, fam, ma), state,
                         dtype=cfg["dtype"])
    ma = (MajorAxis.Short if cfg["kind"] == "saso" else MajorAxis.Long)
    k = min(3, rows, cols)
    return SparseSkOp(SparseDist(rows, cols, k, ma), state,
                      dtype=cfg["dtype"])


# fast tier keeps a 6-config smoke slice of the lattice; the full
# 24-config sweep is the slow tier's job (suite tiering, round 4)
@pytest.mark.parametrize("i", [i if i % 4 == 0 else
                               pytest.param(i, marks=pytest.mark.slow)
                               for i in range(24)])
def test_fuzz_config(i):
    cfg = _random_config(i)
    S = _make_operator(cfg)
    rng = np.random.default_rng(2000 + i)
    if cfg["side"] == "left":
        a_shape = ((cfg["m"], cfg["n"]) if cfg["op_a"] == "N"
                   else (cfg["n"], cfg["m"]))
        out_shape = (cfg["d"], cfg["n"])
    else:
        a_shape = ((cfg["n"], cfg["m"]) if cfg["op_a"] == "N"
                   else (cfg["m"], cfg["n"]))
        out_shape = (cfg["n"], cfg["d"])
    A = rng.normal(size=a_shape).astype(cfg["dtype"])
    B0 = rng.normal(size=out_shape).astype(cfg["dtype"])

    got = np.asarray(sketch_general(
        S, A, side=cfg["side"], op_s=cfg["op_s"], op_a=cfg["op_a"],
        alpha=cfg["alpha"], beta=cfg["beta"], out=jnp.asarray(B0),
        d=cfg["d"], ro_s=cfg["ro"], co_s=cfg["co"]))

    full = np.asarray(S.materialize()).astype(np.float64)
    if cfg["side"] == "left":
        blk = full[cfg["ro"]:, cfg["co"]:][
            :cfg["d"] if cfg["op_s"] == "N" else cfg["m"],
            :cfg["m"] if cfg["op_s"] == "N" else cfg["d"]]
    else:
        blk = full[cfg["ro"]:, cfg["co"]:][
            :cfg["m"] if cfg["op_s"] == "N" else cfg["d"],
            :cfg["d"] if cfg["op_s"] == "N" else cfg["m"]]
    s_eff = blk.T if cfg["op_s"] == "T" else blk
    a_eff = (A.T if cfg["op_a"] == "T" else A).astype(np.float64)
    if cfg["side"] == "left":
        want = cfg["alpha"] * s_eff @ a_eff + cfg["beta"] * B0
    else:
        want = cfg["alpha"] * a_eff @ s_eff + cfg["beta"] * B0
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4,
                               err_msg=str(cfg))


@pytest.mark.parametrize("i", [i if i % 4 == 0 else
                               pytest.param(i, marks=pytest.mark.slow)
                               for i in range(12)])
def test_fuzz_forced_fused_left(i, monkeypatch):
    """Left-side dense f32 lattice with the fused kernel FORCED (both
    counter orientations, interpret mode): every natural layout x op_s
    combination must route through the kernel and match the densify
    oracle."""
    from randblas_tpu import skge
    from randblas_tpu.ops import fused_sketch as fs
    monkeypatch.setattr(skge, "use_fused", True)
    calls = {"n": 0}
    orig = fs.fused_sketch

    def interp(*a, **kw):
        calls["n"] += 1
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(fs, "fused_sketch", interp)

    rng = np.random.default_rng(5000 + i)
    d = int(rng.integers(2, 24))
    m = int(rng.integers(8, 64))
    n = int(rng.integers(1, 12))
    op_s = rng.choice(["N", "T"])
    ro = int(rng.integers(0, 4))
    co = int(rng.integers(0, 4))
    ma = MajorAxis.Long if i % 2 else MajorAxis.Short
    fam = DenseDistName.Gaussian if i % 3 else DenseDistName.Uniform
    blk = (d, m) if op_s == "N" else (m, d)
    S = DenseSkOp(DenseDist(blk[0] + ro, blk[1] + co, fam, ma),
                  RNGState.from_key(300 + i))
    A = jnp.asarray(
        rng.normal(size=(m, n)).astype(np.float32))
    got = sketch_general(S, A, side="left", op_s=op_s, d=d, ro_s=ro,
                         co_s=co)
    assert calls["n"] == 1, f"config {i} did not route through a kernel"
    sub = np.asarray(S.materialize())[ro:ro + blk[0], co:co + blk[1]]
    blkm = sub if op_s == "N" else sub.T
    want = blkm @ np.asarray(A)
    scale = np.abs(want).max() or 1.0
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               atol=2e-2)
