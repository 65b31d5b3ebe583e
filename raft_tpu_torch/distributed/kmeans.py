"""Data-sharded k-means: the Lloyd loop and the balanced EM over
all-reduces (counterpart of ``raft_tpu/distributed/kmeans.py``).

The JAX package runs each fit as one ``shard_map`` holding a
``while_loop`` whose body is a shard-local assignment plus ``psum``s of
the per-cluster sums, counts and inertia. Here each EM step is a
per-shard phase (assign, per-cluster weighted sums) and one ``allreduce``
of each reduction; the host reads the inertia for the stopping test, as
the single-index fit does. Padding rows have weight 0, so they never move
a center or the inertia.

The centers are replicated: every shard starts each step from the same
tensor. Random numbers come from ``torch.Generator``s seeded from
``params.seed`` (``jax.random``'s streams cannot be reproduced): the
k-means++ subsample and draws, and the balanced fit's per-shard uniforms
that elect each cluster's reseed representative.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.cluster.kmeans import (KMeansOutput, KMeansParams,
                                           _init_plus_plus, _init_random)
from raft_tpu_torch.cluster.kmeans_balanced import (KMeansBalancedParams,
                                                    seeded_generators)
from raft_tpu_torch.comms import comms as C
from raft_tpu_torch.core.interruptible import check_interrupt
from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.ops.distance import fused_l2_nn_argmin, matmul_t


def _weighted_sums(X, w, labels, n_clusters: int):
    """Per-cluster Σ w·x and Σ w of one shard."""
    sums = torch.zeros((n_clusters, X.shape[1]), dtype=torch.float32,
                       device=X.device)
    sums.index_add_(0, labels, X * w[:, None])
    counts = torch.zeros(n_clusters, dtype=torch.float32, device=X.device)
    counts.index_add_(0, labels, w)
    return sums, counts


def _m_step(comms, xs, ws, labels, centers, n_clusters: int):
    """The cross-shard weighted centroid update → (centers, global
    counts); empty clusters keep their center."""
    part = comms.map(lambda _r, X, w, lb: _weighted_sums(X, w, lb,
                                                         n_clusters),
                     xs, ws, labels)
    sums = C.allreduce(comms, [p[0] for p in part])[0]
    counts = C.allreduce(comms, [p[1] for p in part])[0]
    centers = torch.where(counts[:, None] > 0,
                          sums / torch.clamp(counts, min=1e-12)[:, None],
                          centers.to(sums.device))
    return centers, counts


def _seed_centers(gen, X, weights, params: KMeansParams, centroids):
    """Initial centers by ``params.init``, as the single-index fit: k-means++
    on a bounded weighted subsample of max(4k, 2048) rows (replicated; the
    full X stays sharded)."""
    k = params.n_clusters
    n = X.shape[0]
    if params.init == "array":
        if centroids is None:
            raise ValueError('init="array" requires centroids')
        return torch.as_tensor(centroids).to(device=X.device,
                                             dtype=torch.float32)
    if params.init == "random":
        return _init_random(gen, X, k)
    n_sample = min(n, max(4 * k, 2048))
    rows = torch.randperm(n, generator=gen, device=X.device)[:n_sample]
    return _init_plus_plus(gen, X[rows], weights[rows], k)


@traced("distributed.kmeans::fit")
def fit(X, params: KMeansParams = KMeansParams(), sample_weight=None,
        centroids=None, comms: Optional[C.Comms] = None,
        res: Optional[Resources] = None,
        device: Optional[DeviceLike] = None) -> Tuple[KMeansOutput,
                                                     torch.Tensor]:
    """Distributed k-means fit → ``(KMeansOutput, labels (n,))``, with the
    single-index fit's semantics (``params.seed`` / ``init`` / ``n_init``;
    ``centroids`` seeds ``init="array"``). X is padded to a multiple of the
    communicator size and row-sharded; padding rows get weight 0."""
    res = resources_for(device, res)
    comms = comms or C.make_comms(res)
    dev0 = comms.devices[0]
    X = torch.as_tensor(X).to(device=dev0, dtype=torch.float32)
    n = X.shape[0]
    k = params.n_clusters
    if not 0 < k <= n:
        raise ValueError(f"n_clusters={k} out of range for n={n}")
    w = (torch.ones(n, dtype=torch.float32, device=dev0)
         if sample_weight is None
         else torch.as_tensor(sample_weight).to(device=dev0,
                                                dtype=torch.float32))
    xs, _ = C.shard_padded(X, comms)
    ws, _ = C.shard_padded(w, comms, fill=0.0)
    (gen,) = seeded_generators(params.seed, 1, dev0)
    best = None
    for _ in range(max(1, params.n_init)):
        centers0 = _seed_centers(gen, X, w, params, centroids)
        centers, inertia, n_iter, labels = _fit_once(
            comms, xs, ws, centers0, int(params.max_iter), float(params.tol),
            res.workspace_bytes)
        if best is None or float(inertia) < float(best[0].inertia):
            best = (KMeansOutput(centers, inertia, n_iter), labels)
        if params.init == "array":
            break  # a fixed start: more inits would repeat it
    out, labels = best
    return out, labels[:n]


def _fit_once(comms, xs, ws, centers0, max_iter: int, tol: float,
              workspace_bytes: int):
    """One Lloyd fit from ``centers0`` → (centers, inertia (0-d), n_iter,
    labels of every padded row, gathered in rank order)."""
    def assign(centers):
        return comms.map(lambda _r, X: fused_l2_nn_argmin(
            X, centers.to(X.device), workspace_bytes=workspace_bytes), xs)

    def step(centers):
        dl = assign(centers)
        new, _ = _m_step(comms, xs, ws, [lb for _, lb in dl], centers,
                         centers.shape[0])
        return new, _inertia(comms, [d for d, _ in dl], ws)

    centers, inertia = step(centers0)
    cur = np.float32(inertia.item())
    prev = np.float32(np.inf)
    factor = np.float32(1.0 - tol)
    it = 1
    while it < max_iter and cur < prev * factor:
        check_interrupt()
        centers, inertia = step(centers)
        prev, cur = cur, np.float32(inertia.item())
        it += 1
    dl = assign(centers)
    inertia = _inertia(comms, [d for d, _ in dl], ws)
    labels = C.allgather(comms, [lb for _, lb in dl], tiled=True)[0]
    return centers, inertia, it, labels


def _inertia(comms, scores: List[torch.Tensor], ws) -> torch.Tensor:
    parts = [torch.sum(s * w).reshape(1) for s, w in zip(scores, ws)]
    return C.allreduce(comms, parts)[0][0]


# ---------------------------------------------------------------------------
# Balanced k-means — the distributed IVF coarse-quantizer trainer
# ---------------------------------------------------------------------------


def _assign_metric(X, centers, metric: str, workspace_bytes: int):
    """(score, labels), lower score better, for either metric."""
    if metric == "inner_product":
        ip = matmul_t(X, centers)
        best, labels = torch.max(ip, dim=1)
        return -best, labels
    return fused_l2_nn_argmin(X, centers, workspace_bytes=workspace_bytes)


def _renorm(centers, metric: str):
    # IP / cosine EM drifts toward zero centers without it
    # (detail/kmeans_balanced.cuh:656-668)
    if metric != "inner_product":
        return centers
    return centers / torch.clamp(
        torch.linalg.vector_norm(centers, dim=1, keepdim=True), min=1e-30)


def _balanced_em(comms, xs, ws, centers, gens, n_clusters: int,
                 n_iters: int, metric: str, threshold: float,
                 workspace_bytes: int):
    """The JAX package's SPMD balanced EM. The reseed elects a global
    random representative of each cluster: per-row uniforms (each shard
    its own generator) weighted by the row weight, a shard-local max, a
    cross-shard ``max``, and a masked ``sum`` that fetches the winning
    row(s); ties fold to the representatives' mean."""
    n_global = float(C.allreduce(
        comms, [torch.sum(w).reshape(1) for w in ws])[0][0])
    average = n_global / n_clusters
    max_iters = 5 * n_iters

    def assign(c):
        return comms.map(lambda _r, X: _assign_metric(
            X, c.to(X.device), metric, workspace_bytes), xs)

    it, rebalancing = 0, True
    while it < n_iters or (rebalancing and it < max_iters):
        check_interrupt()
        labels = [lb for _, lb in assign(centers)]
        centers, counts = _m_step(comms, xs, ws, labels, centers, n_clusters)
        small = counts < threshold * average

        def rep_local(r, X, w, lb):
            u = torch.rand(X.shape[0], generator=gens[r],
                           device=X.device) * w
            maxu = torch.full((n_clusters,), float("-inf"), device=X.device)
            maxu.scatter_reduce_(0, lb, u, reduce="amax")
            return u, torch.clamp(maxu, min=0.0)

        local = comms.map(rep_local, xs, ws, labels)
        maxu = C.allreduce(comms, [m for _, m in local], "max")

        def rep_sums(_r, X, lb, u_m, mx):
            u = u_m[0]
            is_rep = ((u >= mx[lb]) & (u > 0)).to(torch.float32)
            s = torch.zeros((n_clusters, X.shape[1]), dtype=torch.float32,
                            device=X.device)
            s.index_add_(0, lb, X * is_rep[:, None])
            c = torch.zeros(n_clusters, dtype=torch.float32, device=X.device)
            c.index_add_(0, lb, is_rep)
            return s, c

        rs = comms.map(rep_sums, xs, labels, local, maxu)
        rep_sum = C.allreduce(comms, [s for s, _ in rs])[0]
        rep_cnt = C.allreduce(comms, [c for _, c in rs])[0]
        rep_pt = rep_sum / torch.clamp(rep_cnt, min=1.0)[:, None]
        donor_order = torch.argsort(-counts, stable=True)
        rank = torch.clamp(torch.cumsum(small.to(torch.int64), 0) - 1, 0,
                           n_clusters - 1)
        donor = donor_order[rank]
        c_new = 0.5 * (centers[donor] + rep_pt[donor])
        reseed = small & (rep_cnt[donor] > 0)
        centers = _renorm(torch.where(reseed[:, None], c_new, centers),
                          metric)
        rebalancing = bool(small.any())
        it += 1
    # a final M step and re-predict, so the labels match the centers
    labels = [lb for _, lb in assign(centers)]
    centers, _ = _m_step(comms, xs, ws, labels, centers, n_clusters)
    centers = _renorm(centers, metric)
    sl = assign(centers)
    inertia = _inertia(comms, [s for s, _ in sl], ws)
    labels = C.allgather(comms, [lb for _, lb in sl], tiled=True)[0]
    return centers, labels, inertia


@traced("distributed.kmeans::fit_balanced")
def fit_balanced(X, n_clusters: int,
                 params: KMeansBalancedParams = KMeansBalancedParams(),
                 comms: Optional[C.Comms] = None,
                 res: Optional[Resources] = None, health=None,
                 device: Optional[DeviceLike] = None):
    """Data-sharded balanced k-means, the distributed IVF coarse trainer →
    ``(centers, labels (n,), report)``, ``report`` the shard-health
    :class:`~raft_tpu_torch.distributed._sharding.ShardReport`.

    Behind the shard-health gate like the distributed searches: the
    dispatch passes ``probe_shards(..., phase="fit")`` (faultpoint
    ``distributed.kmeans.fit.shard``) first, and a failing shard's rows get
    weight 0 in every reduction: training proceeds over the survivors,
    coverage reported. Labels still come for every row."""
    from raft_tpu_torch.distributed._sharding import probe_shards

    res = resources_for(device, res)
    comms = comms or C.make_comms(res)
    dev0 = comms.devices[0]
    X = torch.as_tensor(X).to(device=dev0, dtype=torch.float32)
    n = X.shape[0]
    if not 0 < n_clusters <= n:
        raise ValueError(f"n_clusters={n_clusters} out of range for n={n}")
    world = comms.size
    report = probe_shards("kmeans", world, n, health, phase="fit")
    w = torch.ones(n, dtype=torch.float32, device=dev0)
    rows_per = -(-n // world)
    for r in range(world):
        if not report.ok[r]:
            w[r * rows_per:(r + 1) * rows_per] = 0.0
    xs, _ = C.shard_padded(X, comms)
    ws, _ = C.shard_padded(w, comms, fill=0.0)
    gen_init, *shard_gens = seeded_generators(params.seed, 1 + world, dev0)
    gens = {}
    for r, d in zip(comms.ranks, comms.devices):
        g = torch.Generator(device=d)
        g.manual_seed(int(torch.randint(0, 2 ** 62, (1,),
                                        generator=shard_gens[r],
                                        device=dev0)))
        gens[r] = g
    rows = torch.randint(0, n, (n_clusters,), generator=gen_init, device=dev0)
    centers0 = X[rows]
    if obs.enabled():
        obs.add("distributed.kmeans.fit_balanced.rows", n)
        obs.add("distributed.kmeans.fit_balanced.clusters", int(n_clusters))
    centers, labels, _ = _balanced_em(
        comms, xs, ws, centers0, gens, int(n_clusters), int(params.n_iters),
        params.metric, float(params.balancing_threshold), res.workspace_bytes)
    return centers, labels[:n], report
