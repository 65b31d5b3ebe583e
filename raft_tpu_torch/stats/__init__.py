"""Statistics and metrics (counterpart of ``raft_tpu/stats``): clustering
comparisons, regression and embedding metrics, ANN recall, and summary
statistics. Names load on first access."""

from raft_tpu_torch._lazy import attach

_METRICS = (
    "accuracy", "adjusted_rand_index", "completeness_score",
    "contingency_matrix", "homogeneity_score", "mutual_info_score",
    "neighborhood_recall", "r2_score", "rand_index", "regression_metrics",
    "silhouette_score", "trustworthiness_score", "v_measure",
)
_SUMMARY = (
    "cov", "dispersion", "entropy", "histogram", "information_criterion",
    "kl_divergence", "mean", "mean_add", "mean_center", "meanvar", "minmax",
    "stddev", "sum_", "vars_", "weighted_mean",
)

__getattr__, __dir__ = attach(
    __name__, {**{n: ("metrics", n) for n in _METRICS},
               **{n: ("summary", n) for n in _SUMMARY}})

__all__ = list(_METRICS + _SUMMARY)
