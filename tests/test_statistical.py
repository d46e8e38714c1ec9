"""Statistical test tier (ports the intent of test_basic_rng/RandBLAS_stats).

- Kolmogorov-Smirnov tests of the Gaussian/uniform scalar streams against
  exact CDFs (test_continuous.cc:55-166), with scipy supplying the
  critical values the reference tabulates from scipy (rng_common.hh:42-170).
- KS for index sampling with/without replacement + degenerate edge cases
  (test_discrete.cc:65-146).
- Subspace embedding distortion: extremal singular values of
  (1/sqrt(d)) S U for an orthonormal U within 1 +- delta
  (test_distortion.cc:49-116) — jnp.linalg replaces the reference's
  handrolled power method.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st

from randblas_tpu import (
    DenseDist, DenseDistName, DenseSkOp, MajorAxis, RNGState, SparseDist,
    SparseSkOp, fill_dense_submat, isometry_scale_factor, sketch_general,
    sample_indices_iid, sample_indices_iid_uniform, weights_to_cdf,
    repeated_fisher_yates,
)

pytestmark = pytest.mark.slow  # distributed/statistical-heavy tier

SIG = 1e-4  # significance level for KS tests (reference sweeps 1e-2..1e-6)


def ks_threshold(n, sig=SIG):
    """Asymptotic two-sided KS critical value (what scipy/the reference's
    tables encode)."""
    return st.kstwobign.ppf(1 - sig) / np.sqrt(n)


@pytest.mark.parametrize("key", [0, 7])
def test_ks_gaussian(key):
    n = 1 << 18
    dist = DenseDist(1 << 9, 1 << 9, DenseDistName.Gaussian)
    samples = np.asarray(
        fill_dense_submat(dist, RNGState.from_key(key), 1 << 9, 1 << 9)
    ).reshape(-1)
    d_stat = st.ks_1samp(samples, st.norm.cdf).statistic
    assert d_stat < ks_threshold(n)


@pytest.mark.parametrize("key", [1, 12])
def test_ks_uniform(key):
    n = 1 << 18
    dist = DenseDist(1 << 9, 1 << 9, DenseDistName.Uniform)
    samples = np.asarray(
        fill_dense_submat(dist, RNGState.from_key(key), 1 << 9, 1 << 9)
    ).reshape(-1)
    r = np.sqrt(3.0)
    d_stat = st.ks_1samp(samples,
                         lambda x: st.uniform.cdf(x, -r, 2 * r)).statistic
    assert d_stat < ks_threshold(n)


def test_ks_index_sampling_with_replacement():
    n, k = 50, 1 << 16
    w = np.linspace(1.0, 3.0, n).astype(np.float32)
    cdf = weights_to_cdf(jnp.asarray(w))
    samples, _ = sample_indices_iid(cdf, k, RNGState.from_key(3))
    probs = w / w.sum()
    hist = np.bincount(np.asarray(samples), minlength=n) / k
    # chi-square goodness of fit
    chi2 = k * np.sum((hist - probs) ** 2 / probs)
    assert chi2 < st.chi2.ppf(1 - SIG, df=n - 1)


def test_ks_index_sampling_uniform():
    n, k = 64, 1 << 16
    samples, _ = sample_indices_iid_uniform(n, k, RNGState.from_key(9))
    hist = np.bincount(np.asarray(samples), minlength=n) / k
    chi2 = k * np.sum((hist - 1.0 / n) ** 2 * n)
    assert chi2 < st.chi2.ppf(1 - SIG, df=n - 1)


def test_fisher_yates_marginals_uniform():
    """Without-replacement sampling: each index equally likely per draw."""
    dim_major, vec_nnz, reps = 12, 4, 4096
    idxs, _ = repeated_fisher_yates(RNGState.from_key(5), vec_nnz,
                                    dim_major, reps)
    counts = np.bincount(np.asarray(idxs).reshape(-1), minlength=dim_major)
    expect = reps * vec_nnz / dim_major
    chi2 = np.sum((counts - expect) ** 2 / expect)
    assert chi2 < st.chi2.ppf(1 - SIG, df=dim_major - 1)


@pytest.mark.parametrize("make_op", [
    lambda d, m: DenseSkOp(DenseDist(d, m), RNGState.from_key(21)),
    lambda d, m: SparseSkOp(SparseDist(d, m, vec_nnz=8,
                                       major_axis=MajorAxis.Short),
                            RNGState.from_key(22)),
])
def test_subspace_embedding_distortion(make_op):
    """sigma(c S U) within 1 +- delta for orthonormal U
    (test_distortion.cc:49-116): N=256-dim subspace of R^4000, d=4N,
    delta=0.5 gives overwhelming success probability."""
    m, N = 4000, 256
    d = 4 * N
    rng = np.random.default_rng(0)
    U, _ = np.linalg.qr(rng.normal(size=(m, N)))
    U = U.astype(np.float32)
    S = make_op(d, m)
    scale = isometry_scale_factor(S.dist)
    SU = np.asarray(sketch_general(S, U, alpha=scale))
    sv = np.linalg.svd(SU, compute_uv=False)
    delta = 0.5
    assert sv.max() < 1 + delta, f"sigma_max {sv.max()}"
    assert sv.min() > 1 - delta, f"sigma_min {sv.min()}"


# ---------------------------------------------------------------------------
# deeper statistical tier (VERDICT r1 item 8): significance sweep with the
# reference's sample-size ladder (test_continuous.cc:121-166), degenerate
# index-sampling distributions (test_discrete.cc:129-162), hypergeometric
# KS for Fisher-Yates (test_discrete.cc:166-237), LASO distortion.
# ---------------------------------------------------------------------------

def _scalar_stream(family, n, key):
    dist = DenseDist(n, 1, family, MajorAxis.Long)
    return np.asarray(
        fill_dense_submat(dist, RNGState.from_key(key), n, 1)).reshape(-1)


def _true_cdf(family):
    if family == DenseDistName.Gaussian:
        return st.norm.cdf
    r = np.sqrt(3.0)
    return lambda x: st.uniform.cdf(x, -r, 2 * r)


@pytest.mark.parametrize("family", [DenseDistName.Gaussian,
                                    DenseDistName.Uniform])
@pytest.mark.parametrize("sig,n,keys", [
    (1e-2, 1_000, (0,)), (1e-2, 10_000, (0,)), (1e-2, 100_000, (0,)),
    (1e-4, 1_000, (0,)), (1e-4, 10_000, (0,)), (1e-4, 100_000, (0,)),
    (1e-6, 1_000, (999, 1000, 1001)),
    (1e-6, 10_000, (999, 1000, 1001)),
    (1e-6, 100_000, (999, 1000, 1001)),
])
def test_ks_significance_sweep(family, sig, n, keys):
    cdf = _true_cdf(family)
    for key in keys:
        d_stat = st.ks_1samp(_scalar_stream(family, n, key), cdf).statistic
        assert d_stat < ks_threshold(n, sig), (family, sig, n, key)


def test_degenerate_distribution_even_support():
    """Mass only on even indices != 10: no sample may land elsewhere
    (test_discrete.cc:135-147)."""
    n = 100
    w = np.zeros(n, np.float32)
    w[::2] = 1.0 / (np.arange(0, n, 2) + 1.0)
    w[10] = 0.0
    cdf = weights_to_cdf(jnp.asarray(w))
    samples, _ = sample_indices_iid(cdf, n * n, RNGState.from_key(13))
    samples = np.asarray(samples)
    assert not ((samples == 10) | (samples % 2 == 1)).any()


def test_degenerate_distribution_delta_with_negative_weight():
    """Delta distribution plus a tiny negative weight that must be clipped
    without error (test_discrete.cc:149-161)."""
    n = 100
    w = np.zeros(n, np.float32)
    w[17] = 99.0
    w[3] = -np.finfo(np.float32).eps / 10
    cdf = weights_to_cdf(jnp.asarray(w))
    assert float(cdf[17]) >= 0.0
    samples, _ = sample_indices_iid(cdf, n * n, RNGState.from_key(14))
    assert (np.asarray(samples) == 17).all()


@pytest.mark.parametrize("N,K", [(20, 5), (50, 8)])
def test_fisher_yates_hypergeometric_ks(N, K):
    """Count of sampled indices below K follows Hypergeometric(N, K, K)
    (test_discrete.cc:166-237)."""
    num_samples = 4096
    idxs, _ = repeated_fisher_yates(RNGState.from_key(6), K, N, num_samples)
    below = (np.asarray(idxs) < K).sum(axis=1)
    emp_cdf = np.cumsum(np.bincount(below, minlength=K + 1)) / num_samples
    true_cdf = st.hypergeom(N, K, K).cdf(np.arange(K + 1))
    assert np.abs(emp_cdf - true_cdf).max() < ks_threshold(num_samples, 1e-4)


def test_subspace_embedding_distortion_laso():
    """LASO (long-axis) sparse operator distortion case."""
    m, N = 4000, 256
    d = 4 * N
    rng = np.random.default_rng(1)
    U, _ = np.linalg.qr(rng.normal(size=(m, N)))
    S = SparseSkOp(SparseDist(d, m, vec_nnz=8, major_axis=MajorAxis.Long),
                   RNGState.from_key(23))
    scale = isometry_scale_factor(S.dist)
    SU = np.asarray(sketch_general(S, jnp.asarray(U.astype(np.float32)),
                                   alpha=scale))
    sv = np.linalg.svd(SU, compute_uv=False)
    assert sv.max() < 1.5 and sv.min() > 0.5, (sv.max(), sv.min())
