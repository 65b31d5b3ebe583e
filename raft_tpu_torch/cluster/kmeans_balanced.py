"""Balanced k-means, the IVF coarse-quantizer trainer (counterpart of
``raft_tpu/cluster/kmeans_balanced.py``).

Each EM step reseeds underweight clusters by splitting the largest ones:
the i-th cluster below ``balancing_threshold × average`` moves to the
midpoint between the i-th largest cluster's center and a random member of
it. The iteration budget extends while rebalancing still fires, capped at
``5·n_iters`` (the pull-back cap). Random numbers come from
``torch.Generator``s seeded from ``params.seed``, so a seed fixes the
result on one device; they are not ``jax.random``'s numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.interruptible import check_interrupt
from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.ops.distance import fused_l2_nn_argmin, matmul_t
from raft_tpu_torch.resilience import faultpoint


@dataclass(frozen=True)
class KMeansBalancedParams:
    n_iters: int = 20
    metric: str = "sqeuclidean"  # "sqeuclidean" | "inner_product"
    seed: int = 0
    balancing_threshold: float = 0.25

    def __post_init__(self):
        if self.metric not in ("sqeuclidean", "inner_product"):
            raise ValueError("kmeans_balanced supports sqeuclidean | inner_product")


def seeded_generators(seed: int, n: int, device: torch.device):
    """``n`` independent generators on ``device`` derived from ``seed``."""
    states = np.random.SeedSequence(int(seed)).generate_state(n, dtype=np.uint64)
    gens = []
    for s in states:
        g = torch.Generator(device=device)
        g.manual_seed(int(s) & 0x7FFFFFFFFFFFFFFF)
        gens.append(g)
    return gens


def _assign(X: torch.Tensor, centers: torch.Tensor, metric: str,
            workspace_bytes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """E step → (score, labels); lower score is better for both metrics."""
    if metric == "inner_product":
        ip = matmul_t(X, centers)
        best, labels = torch.max(ip, dim=1)
        return -best, labels
    return fused_l2_nn_argmin(X, centers, workspace_bytes=workspace_bytes)


def calc_centers_and_sizes(X: torch.Tensor, labels: torch.Tensor,
                           n_clusters: int, old_centers=None):
    """M step: per-cluster means and int32 sizes; empty clusters keep
    ``old_centers`` (or zeros)."""
    X = X.to(torch.float32)
    labels = labels.to(torch.int64)
    sums = torch.zeros((n_clusters, X.shape[1]), dtype=torch.float32,
                       device=X.device)
    sums.index_add_(0, labels, X)
    sizes = torch.bincount(labels, minlength=n_clusters).to(torch.float32)
    means = sums / torch.clamp(sizes, min=1.0)[:, None]
    if old_centers is not None:
        means = torch.where(sizes[:, None] > 0, means, old_centers)
    return means, sizes.to(torch.int32)


def _normalize_rows(c: torch.Tensor) -> torch.Tensor:
    return c / torch.clamp(torch.linalg.vector_norm(c, dim=1, keepdim=True),
                           min=1e-30)


def _balanced_em(X, centers, gen, n_clusters: int, n_iters: int, metric: str,
                 threshold: float, workspace_bytes: int):
    n = X.shape[0]
    dev = X.device
    average = n / n_clusters
    max_iters = 5 * n_iters
    it, rebalancing = 0, True
    arange_n = torch.arange(n, device=dev)
    while it < n_iters or (rebalancing and it < max_iters):
        _, labels = _assign(X, centers, metric, workspace_bytes)
        centers, sizes = calc_centers_and_sizes(X, labels, n_clusters, centers)
        fsizes = sizes.to(torch.float32)
        small = fsizes < threshold * average
        # split the largest clusters: one random member per cluster, and the
        # i-th underweight center goes halfway to the i-th largest's member
        u = torch.rand(n, generator=gen, device=dev)
        maxu = torch.full((n_clusters,), float("-inf"), device=dev)
        maxu.scatter_reduce_(0, labels, u, reduce="amax")
        is_rep = u >= maxu[labels]
        rep = torch.full((n_clusters,), n, dtype=torch.int64, device=dev)
        rep.scatter_reduce_(0, labels, torch.where(is_rep, arange_n, n),
                            reduce="amin")
        donor_order = torch.argsort(-fsizes, stable=True)
        rank = torch.clamp(torch.cumsum(small.to(torch.int64), 0) - 1, 0,
                           n_clusters - 1)
        donor = donor_order[rank]
        donor_pt = X[torch.clamp(rep[donor], 0, n - 1)]
        c_new = 0.5 * (centers[donor] + donor_pt)
        centers = torch.where(small[:, None], c_new, centers)
        if metric == "inner_product":
            centers = _normalize_rows(centers)
        rebalancing = bool(small.any())
        it += 1
    # final M step and re-predict so the labels match the returned centers
    _, labels = _assign(X, centers, metric, workspace_bytes)
    centers, _ = calc_centers_and_sizes(X, labels, n_clusters, centers)
    if metric == "inner_product":
        centers = _normalize_rows(centers)
    _, labels = _assign(X, centers, metric, workspace_bytes)
    sizes = torch.bincount(labels, minlength=n_clusters).to(torch.int32)
    return centers, labels, sizes


def _fit_full(X, n_clusters: int, params: KMeansBalancedParams,
              res: Resources):
    X = torch.as_tensor(X).to(device=res.device, dtype=torch.float32)
    n = X.shape[0]
    if n_clusters > n:
        raise ValueError(f"n_clusters={n_clusters} > n_samples={n}")
    g_init, g_adjust = seeded_generators(params.seed, 2, X.device)
    rows = torch.randint(0, n, (n_clusters,), generator=g_init, device=X.device)
    em_attrs = None
    if obs.enabled():
        obs.add("kmeans_balanced.fits", 1)
        obs.add("kmeans_balanced.rows", n)
        # configured, not executed: the balancing loop may run up to 5× this
        obs.add("kmeans_balanced.iterations_configured", int(params.n_iters))
        em_attrs = {"rows": int(n), "clusters": int(n_clusters),
                    "iters_configured": int(params.n_iters)}
    check_interrupt()
    faultpoint("kmeans_balanced.fit.em")
    with obs.record_span("kmeans_balanced::em", attrs=em_attrs):
        return _balanced_em(X, X[rows].clone(), g_adjust, int(n_clusters),
                            int(params.n_iters), params.metric,
                            float(params.balancing_threshold),
                            int(res.workspace_bytes))


@traced("kmeans_balanced::fit")
def fit(X, n_clusters: int,
        params: KMeansBalancedParams = KMeansBalancedParams(),
        res: Optional[Resources] = None,
        device: Optional[DeviceLike] = None) -> torch.Tensor:
    """Train balanced k-means → (n_clusters, dim) fp32 centers."""
    centers, _, _ = _fit_full(X, n_clusters, params, resources_for(device, res))
    return centers


@traced("kmeans_balanced::fit_predict")
def fit_predict(X, n_clusters: int,
                params: KMeansBalancedParams = KMeansBalancedParams(),
                res: Optional[Resources] = None,
                device: Optional[DeviceLike] = None):
    """(centers, int64 labels) in one pass."""
    centers, labels, _ = _fit_full(X, n_clusters, params,
                                   resources_for(device, res))
    return centers, labels


def predict(X, centers: torch.Tensor,
            params: KMeansBalancedParams = KMeansBalancedParams(),
            res: Optional[Resources] = None,
            device: Optional[DeviceLike] = None) -> torch.Tensor:
    """Nearest-center int64 labels under the params metric."""
    res = resources_for(device, res)
    X = torch.as_tensor(X).to(device=res.device, dtype=torch.float32)
    _, labels = _assign(X, centers.to(res.device), params.metric,
                        res.workspace_bytes)
    return labels
