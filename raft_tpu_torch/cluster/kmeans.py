"""Lloyd k-means with k-means++ seeding (counterpart of
``raft_tpu/cluster/kmeans.py``).

The E step is :func:`~raft_tpu_torch.ops.distance.fused_l2_nn_argmin`, an
fp32 gemm (TF32 off) plus a row argmin, tiled by the workspace budget; the
M step is a weighted ``index_add_``, and an empty cluster keeps its
centre. The JAX package runs the whole EM loop as one ``lax.while_loop``
with no host sync; here the stop condition (the inertia no longer falling
by a relative ``tol``, or ``max_iter`` steps) is checked on the host, one
scalar fetch an iteration, as the reference RAFT does.

k-means++ seeds on a size-capped subsample of ``max(4·k, 16384)`` rows, as
the JAX package does; its random numbers come from a ``torch.Generator``
seeded with ``params.seed``, not from ``jax.random``, so a seed fixes the
result on one device but not the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.interruptible import check_interrupt
from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.ops.distance import fused_l2_nn_argmin, pairwise_distance
from raft_tpu_torch.resilience import active_deadline, faultpoint


@dataclass(frozen=True)
class KMeansParams:
    """Hyper-parameters, the JAX package's ``KMeansParams``."""

    n_clusters: int = 8
    init: str = "k-means++"  # "k-means++" | "random" | "array"
    max_iter: int = 300
    tol: float = 1e-4
    n_init: int = 1
    metric: str = "sqeuclidean"
    seed: int = 0

    def __post_init__(self):
        if self.init not in ("k-means++", "random", "array"):
            raise ValueError(f"unknown init {self.init!r}")
        if self.metric not in ("sqeuclidean", "euclidean", "l2"):
            raise ValueError("kmeans supports L2 metrics only (reference parity)")


class KMeansOutput(NamedTuple):
    centroids: torch.Tensor  # (n_clusters, dim) fp32
    inertia: torch.Tensor    # 0-d fp32: weighted sum of squared distances
    n_iter: int              # EM iterations run


# ---------------------------------------------------------------------------
# EM pieces
# ---------------------------------------------------------------------------


def _update_centers(X, labels, weights, n_clusters: int, old_centers):
    """M step: weighted per-cluster mean; empty clusters keep their centre."""
    sums = torch.zeros((n_clusters, X.shape[1]), dtype=torch.float32,
                       device=X.device)
    sums.index_add_(0, labels, X * weights[:, None])
    counts = torch.zeros(n_clusters, dtype=torch.float32, device=X.device)
    counts.index_add_(0, labels, weights)
    means = sums / torch.clamp(counts, min=1e-12)[:, None]
    return torch.where(counts[:, None] > 0, means, old_centers), counts


def _em_step(X, centers, weights, workspace_bytes: int):
    d2, labels = fused_l2_nn_argmin(X, centers,
                                    workspace_bytes=workspace_bytes)
    new_centers, _ = _update_centers(X, labels, weights, centers.shape[0],
                                     centers)
    return new_centers, torch.sum(d2 * weights)


def _lloyd(X, centers0, weights, max_iter: int, tol: float,
           workspace_bytes: int, history: Optional[List[float]] = None):
    """The Lloyd loop (the reference's fit_main): EM steps until the inertia
    stops falling by a relative ``tol`` or ``max_iter`` steps ran →
    (centers, inertia of the returned centers, n_iter). One scalar fetch an
    iteration; the comparison is the JAX loop's, in fp32. ``history``, when
    given, receives each step's inertia."""
    centers, inertia = _em_step(X, centers0, weights, workspace_bytes)
    cur = np.float32(inertia.item())
    if history is not None:
        history.append(float(cur))
    prev = np.float32(np.inf)
    factor = np.float32(1.0 - tol)
    it = 1
    while it < max_iter and cur < prev * factor:
        check_interrupt()
        centers, inertia = _em_step(X, centers, weights, workspace_bytes)
        prev, cur = cur, np.float32(inertia.item())
        if history is not None:
            history.append(float(cur))
        it += 1
    # the reported inertia is that of the returned centers
    d2, _ = fused_l2_nn_argmin(X, centers, workspace_bytes=workspace_bytes)
    return centers, torch.sum(d2 * weights), it


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def _init_plus_plus(gen: torch.Generator, X, weights, n_clusters: int):
    """k-means++ seeding: the first centre uniform, each next one drawn ∝
    weight·D²(x) to the centres chosen so far, on a random subsample of
    ``max(4·k, 16384)`` rows (the k sequential sweeps stay small; the Lloyd
    steps see every row)."""
    n = X.shape[0]
    max_rows = max(4 * n_clusters, 16384)
    if n > max_rows:
        rows = torch.randperm(n, generator=gen, device=X.device)[:max_rows]
        X = X[rows]
        weights = weights[rows]
        n = max_rows
    first = torch.randint(0, n, (1,), generator=gen, device=X.device)
    centers = torch.zeros((n_clusters, X.shape[1]), dtype=X.dtype,
                          device=X.device)
    centers[0] = X[first[0]]
    d2 = torch.sum((X - X[first]) ** 2, dim=1)
    for i in range(1, n_clusters):
        p = torch.clamp(d2 * weights, min=1e-30)
        nxt = torch.multinomial(p, 1, generator=gen)
        centers[i] = X[nxt[0]]
        d2 = torch.minimum(d2, torch.sum((X - X[nxt]) ** 2, dim=1))
    return centers


def _init_random(gen: torch.Generator, X, n_clusters: int):
    rows = torch.randperm(X.shape[0], generator=gen, device=X.device)
    return X[rows[:n_clusters]]


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _weights(sample_weight, n: int, dev) -> torch.Tensor:
    if sample_weight is None:
        return torch.ones(n, dtype=torch.float32, device=dev)
    return torch.as_tensor(sample_weight).to(device=dev, dtype=torch.float32)


@traced("kmeans::fit")
def fit(X, params: KMeansParams = KMeansParams(), sample_weight=None,
        centroids=None, res: Optional[Resources] = None,
        device: Optional[DeviceLike] = None) -> KMeansOutput:
    """Train k-means: ``params.n_init`` seeded fits, keeping the one of
    lowest inertia; ``centroids`` seeds the fit when ``params.init ==
    "array"`` (one fit: the start is fixed).

    Between fits, ``check_interrupt`` runs (and so any hard deadline), the
    ``kmeans.fit.em`` faultpoint fires, and a spent soft
    :class:`~raft_tpu_torch.resilience.Deadline` keeps the best fit so far
    and marks it degraded. With ``metric="euclidean"`` the reported inertia
    is the sum of distances, not of their squares."""
    res = resources_for(device, res)
    dev = res.device
    X = torch.as_tensor(X).to(device=dev, dtype=torch.float32)
    n = X.shape[0]
    if params.n_clusters > n:
        raise ValueError(f"n_clusters={params.n_clusters} > n_samples={n}")
    weights = _weights(sample_weight, n, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(params.seed))

    best: Optional[KMeansOutput] = None
    for _ in range(max(1, params.n_init)):
        # a spent deadline keeps the best fit so far (fewer restarts, still
        # a valid model) instead of being cut mid-restart
        dl = active_deadline()
        if dl is not None and best is not None and dl.reached():
            dl.mark_degraded("kmeans.fit")
            break
        check_interrupt()
        faultpoint("kmeans.fit.em")
        if params.init == "array":
            if centroids is None:
                raise ValueError('init="array" requires centroids')
            centers0 = torch.as_tensor(centroids).to(device=dev,
                                                     dtype=torch.float32)
        elif params.init == "random":
            centers0 = _init_random(gen, X, params.n_clusters)
        else:
            centers0 = _init_plus_plus(gen, X, weights, params.n_clusters)
        out = KMeansOutput(*_lloyd(X, centers0, weights, params.max_iter,
                                   float(params.tol), res.workspace_bytes))
        if best is None or float(out.inertia) < float(best.inertia):
            best = out
        if params.init == "array":
            break  # a fixed start: more fits would be identical
    if params.metric == "euclidean":
        d, _ = fused_l2_nn_argmin(X, best.centroids, sqrt=True,
                                  workspace_bytes=res.workspace_bytes)
        best = best._replace(inertia=torch.sum(d * weights))
    if obs.enabled():
        obs.add("kmeans.fits", 1)
        obs.add("kmeans.rows", n)
        obs.add("kmeans.iterations", int(best.n_iter))
    return best


def predict(X, centroids, sample_weight=None,
            res: Optional[Resources] = None,
            device: Optional[DeviceLike] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's nearest centroid → (int64 labels, inertia)."""
    res = resources_for(device, res)
    X = torch.as_tensor(X).to(device=res.device, dtype=torch.float32)
    c = torch.as_tensor(centroids).to(device=res.device, dtype=torch.float32)
    d2, labels = fused_l2_nn_argmin(X, c, workspace_bytes=res.workspace_bytes)
    if sample_weight is not None:
        d2 = d2 * _weights(sample_weight, X.shape[0], res.device)
    return labels, torch.sum(d2)


@traced("kmeans::fit_predict")
def fit_predict(X, params: KMeansParams = KMeansParams(), sample_weight=None,
                centroids=None, res: Optional[Resources] = None,
                device: Optional[DeviceLike] = None
                ) -> Tuple[torch.Tensor, KMeansOutput]:
    """fit + predict in one call → (labels, output)."""
    res = resources_for(device, res)
    out = fit(X, params, sample_weight=sample_weight, centroids=centroids,
              res=res)
    labels, _ = predict(X, out.centroids, res=res)
    return labels, out


def transform(X, centroids, res: Optional[Resources] = None,
              device: Optional[DeviceLike] = None) -> torch.Tensor:
    """Squared L2 distance from every row to every centroid."""
    return pairwise_distance(X, centroids, metric="sqeuclidean", res=res,
                             device=device)


def cluster_cost(X, centroids, res: Optional[Resources] = None,
                 device: Optional[DeviceLike] = None) -> torch.Tensor:
    """Sum of squared distances to the nearest centroid."""
    res = resources_for(device, res)
    X = torch.as_tensor(X).to(device=res.device, dtype=torch.float32)
    c = torch.as_tensor(centroids).to(device=res.device, dtype=torch.float32)
    d2, _ = fused_l2_nn_argmin(X, c, workspace_bytes=res.workspace_bytes)
    return torch.sum(d2)
