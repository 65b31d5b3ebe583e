"""Port parity: ``raft_tpu_torch.stats.{metrics,summary}`` against the JAX
package on the same numpy inputs (``device="cpu"``).

Tolerances: integer results (contingency matrices, histograms) exact;
elementwise fp32 at rtol 1e-6; reductions and metrics at rtol 1e-5 (the
port sums counts in float64 where JAX sums fp32, and fp32 sums run in
another order). ``regression_metrics``' median is the mean of the two
middle values, as ``jnp.median``'s (``torch.median`` takes the lower).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.stats import metrics as jmet
from raft_tpu.stats import summary as jsum
from raft_tpu_torch.stats import metrics as tmet
from raft_tpu_torch.stats import summary as tsum

torch.set_num_threads(2)
CPU = "cpu"


def _labels(seed, n=2000, k=12):
    return np.random.default_rng(seed).integers(0, k, n).astype(np.int32)


def _close(got, want, rtol=1e-5, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


# -- clustering comparisons --------------------------------------------------

LABEL_PAIRS = {
    "random": (_labels(0), _labels(1, k=9)),
    "agreeing": (_labels(2), (_labels(2) * 7 + 3) % 12),     # a relabelling
    "noisy": (_labels(3), np.where(np.random.default_rng(4).random(2000)
                                   < 0.2, _labels(5), _labels(3))),
    "one_class": (np.zeros(500, np.int32), _labels(6, 500)),
}


@pytest.mark.parametrize("case", sorted(LABEL_PAIRS))
def test_contingency_matrix_equals_jax_exactly(case):
    t, p = LABEL_PAIRS[case]
    got = tmet.contingency_matrix(t, p, device=CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jmet.contingency_matrix(t, p)))


def test_contingency_matrix_with_class_counts_drops_out_of_range():
    t, p = _labels(7, 300, 6), _labels(8, 300, 6)
    got = tmet.contingency_matrix(t, p, 4, 5, device=CPU).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jmet.contingency_matrix(t, p, 4, 5)))


@pytest.mark.parametrize("metric", ["rand_index", "adjusted_rand_index",
                                    "mutual_info_score", "homogeneity_score",
                                    "completeness_score", "v_measure"])
@pytest.mark.parametrize("case", sorted(LABEL_PAIRS))
def test_clustering_metrics_equal_jax(metric, case):
    t, p = LABEL_PAIRS[case]
    got = getattr(tmet, metric)(t, p, device=CPU)
    assert got.dtype == torch.float32
    _close(got, getattr(jmet, metric)(t, p))


def test_v_measure_beta_and_accuracy_equal_jax():
    t, p = LABEL_PAIRS["noisy"]
    _close(tmet.v_measure(t, p, beta=2.0, device=CPU),
           jmet.v_measure(t, p, beta=2.0))
    _close(tmet.accuracy(t, p, device=CPU), jmet.accuracy(t, p))


# -- regression ---------------------------------------------------------------

@pytest.mark.parametrize("n", [1000, 1001])
def test_regression_metrics_and_r2_equal_jax(n):
    rng = np.random.default_rng(9)
    y = rng.standard_normal(n).astype(np.float32)
    y_hat = (y + 0.3 * rng.standard_normal(n)).astype(np.float32)
    got = tmet.regression_metrics(y_hat, y, device=CPU)
    want = jmet.regression_metrics(y_hat, y)
    for g, w in zip(got, want):
        _close(g, w)
    _close(tmet.r2_score(y, y_hat, device=CPU), jmet.r2_score(y, y_hat))


def test_median_of_an_even_count_is_the_midpoint():
    got = tmet.regression_metrics([1.0, 2.0, 3.0, 4.0], [0.0] * 4,
                                  device=CPU)[2]
    assert float(got) == 2.5 == float(jmet.regression_metrics(
        jnp.asarray([1.0, 2.0, 3.0, 4.0]), jnp.zeros(4))[2])


# -- silhouette, trustworthiness ----------------------------------------------

def _clusters(seed, n=600, k=5, dim=6):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, k, n)
    x = rng.standard_normal((k, dim))[lab] * 4 + rng.standard_normal((n, dim))
    return x.astype(np.float32), lab.astype(np.int32)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean"])
@pytest.mark.parametrize("tile_rows", [2048, 128])
def test_silhouette_score_equals_jax(metric, tile_rows):
    x, lab = _clusters(10)
    lab[:3] = 7                         # a singleton-free extra cluster
    lab[3] = 8                          # a singleton: scores 0
    got = tmet.silhouette_score(x, lab, 10, metric, tile_rows, device=CPU)
    _close(got, jmet.silhouette_score(x, lab, 10, metric, tile_rows))


@pytest.mark.parametrize("k,batch", [(5, 512), (10, 128)])
def test_trustworthiness_score_equals_jax(k, batch):
    x, _ = _clusters(11, n=500)
    rng = np.random.default_rng(12)
    emb = (x[:, :2] + 0.5 * rng.standard_normal((500, 2))).astype(np.float32)
    emb[:20] = np.round(emb[:20])       # ties in the embedded distances
    got = tmet.trustworthiness_score(x, emb, k, batch_size=batch, device=CPU)
    _close(got, jmet.trustworthiness_score(x, emb, k, batch_size=batch))


# -- summary statistics -------------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("sample", [True, False])
def test_moments_equal_jax(axis, sample):
    x = np.random.default_rng(13).standard_normal((200, 9)).astype(np.float32)
    _close(tsum.sum_(x, axis, device=CPU), jsum.sum_(x, axis))
    _close(tsum.mean(x, axis, device=CPU), jsum.mean(x, axis))
    _close(tsum.mean_center(x, axis=axis, device=CPU),
           jsum.mean_center(x, axis=axis), atol=1e-6)
    mu = np.asarray(jsum.mean(x, axis))
    _close(tsum.mean_add(x, mu, axis, device=CPU), jsum.mean_add(x, mu, axis),
           rtol=1e-6)
    _close(tsum.vars_(x, sample=sample, axis=axis, device=CPU),
           jsum.vars_(x, sample=sample, axis=axis))
    _close(tsum.stddev(x, sample=sample, axis=axis, device=CPU),
           jsum.stddev(x, sample=sample, axis=axis))
    for g, w in zip(tsum.meanvar(x, sample, axis, device=CPU),
                    jsum.meanvar(x, sample, axis)):
        _close(g, w)
    for g, w in zip(tsum.minmax(x, axis, device=CPU), jsum.minmax(x, axis)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_integer_sums_are_int32_as_jax():
    x = np.random.default_rng(14).integers(-50, 50, (40, 3)).astype(np.int32)
    got = tsum.sum_(x, device=CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsum.sum_(x)))


@pytest.mark.parametrize("shape", [(500,), (500, 4)])
def test_histogram_equals_jax_exactly(shape):
    """Samples in range, on bin edges, below ``lower`` (truncation toward
    zero puts (−width, 0) in bin 0 before the clamp) and past ``upper``."""
    rng = np.random.default_rng(15)
    x = rng.uniform(-1.5, 5.5, shape).astype(np.float32)
    x.reshape(-1)[:6] = [-0.3, 0.0, 0.5, 4.0, 3.999, -2.0]
    got = tsum.histogram(x, 8, 0.0, 4.0, device=CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jsum.histogram(x, 8, 0.0, 4.0)))


@pytest.mark.parametrize("axis", [0, 1])
def test_weighted_mean_and_dispersion_equal_jax(axis):
    rng = np.random.default_rng(16)
    x = rng.standard_normal((30, 7)).astype(np.float32)
    w = rng.random(x.shape[axis]).astype(np.float32)
    _close(tsum.weighted_mean(x, w, axis, device=CPU),
           jsum.weighted_mean(x, w, axis), atol=1e-6)
    sizes = rng.integers(1, 40, 30).astype(np.int32)
    _close(tsum.dispersion(x, sizes, device=CPU), jsum.dispersion(x, sizes))
    g = x.mean(0)
    _close(tsum.dispersion(x, sizes, g, device=CPU),
           jsum.dispersion(x, sizes, g))


@pytest.mark.parametrize("labels,n", [([-1, 0, 1, 5], 3),
                                      (list(_labels(17, 300, 9)), 9),
                                      (list(_labels(18, 300, 9)), 5)])
def test_entropy_bins_as_jax_bincount(labels, n):
    lab = np.asarray(labels, np.int32)
    _close(tsum.entropy(lab, n, device=CPU), jsum.entropy(lab, n))


def test_kl_divergence_and_information_criteria_equal_jax():
    rng = np.random.default_rng(19)
    p = rng.random(20).astype(np.float32)
    p[3] = 0.0
    q = rng.random(20).astype(np.float32)
    _close(tsum.kl_divergence(p / p.sum(), q / q.sum(), device=CPU),
           jsum.kl_divergence(p / p.sum(), q / q.sum()))
    ll = rng.standard_normal(6).astype(np.float32) * 100
    for ic in ("aic", "aicc", "bic"):
        _close(tsum.information_criterion(ll, ic, 4, 120, device=CPU),
               jsum.information_criterion(ll, ic, 4, 120), rtol=1e-6)
    with pytest.raises(ValueError):
        tsum.information_criterion(ll, "hqic", 4, 120, device=CPU)
