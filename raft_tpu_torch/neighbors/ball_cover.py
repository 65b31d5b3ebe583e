"""Random ball cover: exact kNN by landmark triangle-inequality pruning
(counterpart of ``raft_tpu/neighbors/ball_cover.py``).

√n landmarks are drawn, every point joins its nearest landmark's ball, and
each ball keeps its radius. A query visits the balls in the order of its
lower bound max(0, d(q, l) − radius_l), a batch of balls at a time for all
queries in lockstep, and stops when every query's next bound exceeds its
k-th distance (one host read a batch). Ranking distances are squared L2
(the k-th compared as its square root) for the Euclidean metrics and
great-circle radians for haversine, as in the JAX package.

Landmarks come from a ``torch.Generator`` seeded from ``seed`` where the
JAX package draws ``jax.random.choice``: a port-built index is exact
against brute force, and a JAX-built index can be carried in by its arrays
(:class:`BallCoverIndex` holds them as they are). Queries run in tiles
sized by the workspace (the gathered (tile, batch, m, dim) block), which
changes no query's answer: a tile only stops later for a query already
done, whose remaining balls lie past its k-th distance.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.neighbors._packing import pack_lists
from raft_tpu_torch.ops import distance as dist_mod

SUPPORTED_METRICS = ("sqeuclidean", "euclidean", "haversine")
_GROUP = 32


@dataclass
class BallCoverIndex:
    """Landmarks, padded member lists and per-landmark radii."""

    landmarks: torch.Tensor   # (L, dim) fp32
    list_data: torch.Tensor   # (L, m, dim)
    list_ids: torch.Tensor    # (L, m) int32, -1 padding
    radii: torch.Tensor       # (L,) euclidean radius of each ball
    metric: str

    @property
    def n_landmarks(self) -> int:
        return self.landmarks.shape[0]

    @property
    def dim(self) -> int:
        return self.landmarks.shape[1]

    @property
    def device(self) -> torch.device:
        return self.landmarks.device

    @property
    def size(self) -> int:
        return int((self.list_ids >= 0).sum())


@traced("ball_cover::build")
def build(dataset, n_landmarks: int = 0, metric: str = "euclidean",
          seed: int = 0, res: Optional[Resources] = None,
          device: Optional[DeviceLike] = None) -> BallCoverIndex:
    """Sample √n landmarks (without replacement), assign every point to its
    nearest landmark, record the balls' radii."""
    res = resources_for(device, res)
    metric = dist_mod.canonical_metric(metric)
    if metric not in SUPPORTED_METRICS:
        raise ValueError(
            f"ball_cover supports {SUPPORTED_METRICS}, got {metric!r}")
    dataset = torch.as_tensor(dataset).to(device=res.device,
                                          dtype=torch.float32)
    n, _ = dataset.shape
    L = int(n_landmarks) or max(1, int(n ** 0.5))
    if L > n:
        raise ValueError(f"n_landmarks={L} > n_rows={n}")
    gen = torch.Generator(device=res.device)
    gen.manual_seed(int(seed))
    rows = torch.randperm(n, generator=gen, device=res.device)[:L]
    landmarks = dataset[rows]
    if metric == "haversine":
        d = dist_mod.haversine(dataset, landmarks)
        labels = torch.argmin(d, dim=1)
        dist_to_lm = torch.gather(d, 1, labels[:, None])[:, 0]
    else:
        d2 = dist_mod.pairwise_distance(dataset, landmarks, "sqeuclidean",
                                        res=res)
        labels = torch.argmin(d2, dim=1)
        dist_to_lm = torch.sqrt(torch.clamp(
            torch.gather(d2, 1, labels[:, None])[:, 0], min=0.0))
    row_ids = torch.arange(n, dtype=torch.int32, device=res.device)
    list_data, list_ids = pack_lists(dataset, row_ids, labels, L, _GROUP)
    radii = torch.full((L,), float("-inf"), device=res.device).scatter_reduce(
        0, labels, dist_to_lm, "amax", include_self=False)
    radii = torch.where(torch.isfinite(radii), radii, 0.0)
    return BallCoverIndex(landmarks, list_data, list_ids, radii, metric)


def _haversine_rows(queries: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """Great-circle distance of each query to its own candidate rows
    (q, c, 2) → (q, c)."""
    sin_dlat = torch.sin(0.5 * (flat[:, :, 0] - queries[:, None, 0]))
    sin_dlon = torch.sin(0.5 * (flat[:, :, 1] - queries[:, None, 1]))
    a = (sin_dlat ** 2 + torch.cos(queries[:, None, 0])
         * torch.cos(flat[:, :, 0]) * sin_dlon ** 2)
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def _query_tile(queries, landmarks, list_data, list_ids, radii, k: int,
                batch: int, haversine: bool):
    """The lockstep landmark walk for one tile of queries."""
    q, dim = queries.shape
    L, m, _ = list_data.shape
    nb = -(-L // batch)
    if haversine:
        d_ql = dist_mod.haversine(queries, landmarks)
    else:
        d_ql = torch.sqrt(torch.clamp(dist_mod._expanded_distance(
            queries, landmarks, "sqeuclidean"), min=0.0))
    lb = torch.clamp(d_ql - radii[None, :], min=0.0)
    order = torch.argsort(lb, dim=1, stable=True)
    lb_sorted = torch.gather(lb, 1, order)
    # pad the visit order to a batch multiple by repeating the last ball
    # (rescanning a list is harmless for a top-k merge)
    pad = nb * batch - L
    if pad:
        order = torch.cat([order, order[:, -1:].expand(q, pad)], dim=1)
        lb_sorted = torch.cat([lb_sorted, lb_sorted[:, -1:].expand(q, pad)],
                              dim=1)
    qn = dist_mod.sqnorm(queries)
    norms = torch.where(list_ids >= 0, dist_mod.sqnorm(list_data, dim=2),
                        float("inf"))
    best_v = torch.full((q, k), float("inf"), dtype=torch.float32,
                        device=queries.device)
    best_i = torch.full((q, k), -1, dtype=torch.int32, device=queries.device)
    b = 0
    while b < nb:
        kth = best_v[:, k - 1]
        if not haversine:
            kth = torch.sqrt(torch.clamp(kth, min=0.0))
        nxt = lb_sorted[:, min(b * batch, nb * batch - 1)]
        if not bool(((nxt <= kth) | ~torch.isfinite(kth)).any()):
            break
        lists = order[:, b * batch:(b + 1) * batch]            # (q, B)
        cand = list_data[lists].reshape(q, batch * m, dim)
        ids = list_ids[lists].reshape(q, batch * m)
        if haversine:
            d2 = _haversine_rows(queries, cand)
        else:
            nrm = norms[lists].reshape(q, batch * m)
            ip = torch.bmm(cand, queries[:, :, None])[:, :, 0]
            d2 = torch.clamp(qn[:, None] + nrm - 2.0 * ip, min=0.0)
        d2 = torch.where(ids >= 0, d2, float("inf"))
        allv = torch.cat([best_v, d2], dim=1)
        alli = torch.cat([best_i, ids], dim=1)
        allv, sel = torch.sort(allv, dim=1, stable=True)
        best_v = allv[:, :k]
        best_i = torch.gather(alli, 1, sel[:, :k])
        b += 1
    return best_v, best_i


def knn_query(index: BallCoverIndex, queries, k: int, batch: int = 8,
              res: Optional[Resources] = None,
              device: Optional[DeviceLike] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN against the indexed points → (distances, indices) in the
    index's metric."""
    res = resources_for(device, res)
    if index.device != res.device:
        raise ValueError(f"index lives on {index.device}, the query runs on "
                         f"{res.device}")
    queries = torch.as_tensor(queries).to(device=res.device,
                                          dtype=torch.float32)
    if queries.ndim != 2 or queries.shape[1] != index.dim:
        raise ValueError(
            f"queries must be (q, {index.dim}), got {tuple(queries.shape)}")
    if not 0 < k <= index.size:
        raise ValueError(f"k={k} out of range for {index.size} points")
    m = index.list_data.shape[1]
    per_query = int(batch) * m * (index.dim + 4) * 4 * 2
    q_tile = int(max(1, res.workspace_bytes // max(1, per_query)))
    vs, is_ = [], []
    for s in range(0, queries.shape[0], q_tile):
        v, i = _query_tile(queries[s:s + q_tile], index.landmarks,
                           index.list_data, index.list_ids, index.radii,
                           int(k), int(batch), index.metric == "haversine")
        vs.append(v)
        is_.append(i)
    v = torch.cat(vs) if vs else torch.zeros((0, k), device=res.device)
    i = torch.cat(is_) if is_ else torch.zeros((0, k), dtype=torch.int32,
                                                device=res.device)
    if index.metric == "euclidean":
        v = torch.sqrt(torch.clamp(v, min=0.0))
    return torch.where(i >= 0, v, float("inf")), i


def all_knn_query(index: BallCoverIndex, k: int, batch: int = 8,
                  res: Optional[Resources] = None,
                  device: Optional[DeviceLike] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN of every indexed point against the index, self included; rows
    in source-id order."""
    flat_ids = index.list_ids.reshape(-1)
    flat = index.list_data.reshape(-1, index.dim)
    valid = flat_ids >= 0
    dataset = torch.zeros((index.size, index.dim), dtype=torch.float32,
                          device=index.device)
    dataset[flat_ids[valid].long()] = flat[valid].to(torch.float32)
    return knn_query(index, dataset, k, batch=batch, res=res, device=device)


def eps_nn(index: BallCoverIndex, queries, eps: float,
           res: Optional[Resources] = None,
           device: Optional[DeviceLike] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All index points within L2 radius ``eps`` of each query →
    (adjacency (q, n) bool over source ids, degree (q,) int32). Balls whose
    lower bound exceeds eps contribute nothing."""
    res = resources_for(device, res)
    if index.device != res.device:
        raise ValueError(f"index lives on {index.device}, the query runs on "
                         f"{res.device}")
    queries = torch.as_tensor(queries).to(device=res.device,
                                          dtype=torch.float32)
    if eps <= 0:
        raise ValueError(f"eps must be positive, got {eps}")
    n = index.size
    L, m, dim = index.list_data.shape
    flat_ids = index.list_ids.reshape(-1)
    valid = flat_ids >= 0
    cols = flat_ids[valid].long()
    norms = torch.where(index.list_ids >= 0,
                        dist_mod.sqnorm(index.list_data, dim=2), float("inf"))
    flat = index.list_data.reshape(L * m, dim).to(torch.float32)
    q_tile = int(max(1, res.workspace_bytes // max(1, L * m * 4 * 4)))
    adj = torch.zeros((queries.shape[0], n), dtype=torch.bool,
                      device=res.device)
    for s in range(0, queries.shape[0], q_tile):
        qt = queries[s:s + q_tile]
        d_ql = torch.sqrt(torch.clamp(dist_mod._expanded_distance(
            qt, index.landmarks, "sqeuclidean"), min=0.0))
        ball_ok = (d_ql - index.radii[None, :]) <= eps
        ip = dist_mod.matmul_t(qt, flat).reshape(qt.shape[0], L, m)
        d2 = torch.clamp(dist_mod.sqnorm(qt)[:, None, None] + norms[None]
                         - 2.0 * ip, min=0.0)
        within = (d2 <= eps * eps) & ball_ok[:, :, None] \
            & (index.list_ids >= 0)[None]
        adj[s:s + q_tile, cols] = within.reshape(qt.shape[0], -1)[:, valid]
    return adj, adj.sum(dim=1, dtype=torch.int32)
