"""Sharded CAGRA: one local graph a shard, replicated queries, a
cross-shard merge (counterpart of ``raft_tpu/distributed/cagra.py``).

The raft-dask MNMG ANN layout: every shard owns an independent index over
its row partition, queries go to all, results merge as knn_merge_parts
does. The graph's irregular hops stay shard-local; the data scales.

The build loops the local shards (each a single-index
:func:`raft_tpu_torch.neighbors.cagra.build`, so on a card each shard's
candidate scan runs K1); on ``process_group`` each process builds only its
own. The search walks each shard's graph with the shard body's traversal,
resolved with ``allow_fused=False`` as in the JAX package: with the
compression payload that is the compressed loop in plain torch, on a card
too (K6 is a single-index kernel), else the exact loop.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import torch

from raft_tpu_torch.cluster.kmeans_balanced import seeded_generators
from raft_tpu_torch.comms import comms as C
from raft_tpu_torch.core.resources import (DeviceLike, Resources,
                                           resources_for)
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.distributed._sharding import (SearchResult, blank_dead,
                                                  merge_shards, probe_shards)
from raft_tpu_torch.neighbors import cagra as sl
from raft_tpu_torch.ops.distance import sqnorm

# padded shard rows hold this coordinate: a query's distance to them is
# ~1e36, so they never enter a top-k
_PAD_SENTINEL = 1e18
_PAYLOAD_CORE = ("proj", "code_scale", "nbr_codes", "proj_energy")


@dataclass
class ShardedCagraIndex:
    """Row-sharded CAGRA: each local shard's padded rows (fp32) and graph
    (shard-LOCAL ids; the search maps them to rank·rows_per + local). When
    every shard built the compression payload, each shard's payload rides
    along and the search runs the compressed loop."""

    dataset: List[torch.Tensor]        # (rows_per, dim) fp32 a shard
    graph: List[torch.Tensor]          # (rows_per, graph_degree) int32
    n_total: int
    comms: C.Comms
    proj: Optional[List[torch.Tensor]] = None
    code_scale: Optional[List[torch.Tensor]] = None   # 0-d a shard
    nbr_codes: Optional[List[torch.Tensor]] = None
    centroids: Optional[List[torch.Tensor]] = None
    centroid_reps: Optional[List[torch.Tensor]] = None  # LOCAL ids
    proj_energy: Optional[List[torch.Tensor]] = None    # 0-d a shard

    @property
    def dim(self) -> int:
        return self.dataset[0].shape[1]

    @property
    def size(self) -> int:
        return self.n_total

    @property
    def graph_degree(self) -> int:
        return self.graph[0].shape[1]

    @property
    def rows_per_shard(self) -> int:
        return self.dataset[0].shape[0]

    def shard_index(self, i: int) -> sl.CagraIndex:
        """Local shard ``i`` (in ``comms.local`` order) as a single index."""
        opt = {}
        for name in ("proj", "code_scale", "nbr_codes", "centroids",
                     "centroid_reps", "proj_energy"):
            parts = getattr(self, name)
            if parts is not None:
                opt[name] = parts[i]
        d = self.dataset[i]
        return sl.CagraIndex(d, self.graph[i], sqnorm(d), **opt)


@traced("distributed.cagra::build")
def build(dataset, params: sl.CagraParams = sl.CagraParams(),
          comms: Optional[C.Comms] = None, res: Optional[Resources] = None,
          device: Optional[DeviceLike] = None) -> ShardedCagraIndex:
    """One CAGRA build a local shard over its row partition."""
    res = resources_for(device, res)
    comms = comms or C.make_comms(res)
    world = comms.size
    X = torch.as_tensor(dataset)
    n, dim = X.shape
    rows_per = -(-n // world)
    if rows_per <= params.graph_degree:
        raise ValueError(f"shard rows {rows_per} must exceed graph_degree "
                         f"{params.graph_degree}")
    # compress="auto" resolves once from the GLOBAL row count: a short
    # tail shard must not drop every other shard's payload
    compress_on = params.compress == "on" or (
        params.compress == "auto" and n >= params.compress_threshold)
    params = dataclasses.replace(params,
                                 compress="on" if compress_on else "off")
    names = ("proj", "code_scale", "nbr_codes", "centroids", "centroid_reps",
             "proj_energy")
    ds_parts, g_parts = [], []
    payload = {k: [] for k in names}
    for r, dev in zip(comms.ranks, comms.devices):
        Xr = X[r * rows_per:min((r + 1) * rows_per, n)].to(dev)
        li = sl.build(Xr, params, res=Resources(dev, res.workspace_bytes,
                                                res.compute_dtype))
        pad = rows_per - Xr.shape[0]
        d = li.dataset.to(torch.float32)
        g = li.graph
        if pad:
            d = torch.cat([d, torch.full((pad, dim), _PAD_SENTINEL,
                                         dtype=torch.float32, device=dev)])
            g = torch.cat([g, torch.full((pad, g.shape[1]), -1,
                                         dtype=g.dtype, device=dev)])
        ds_parts.append(d)
        g_parts.append(g)
        if li.nbr_codes is not None:
            payload["proj"].append(li.proj)
            payload["code_scale"].append(li.code_scale)
            payload["nbr_codes"].append(torch.nn.functional.pad(
                li.nbr_codes, (0, 0, 0, 0, 0, pad)) if pad else li.nbr_codes)
            payload["centroids"].append(li.centroids)
            payload["centroid_reps"].append(li.centroid_reps)
            payload["proj_energy"].append(
                li.proj_energy if li.proj_energy is not None
                else torch.tensor(li.proj.shape[1] / dim, device=dev))
    opt = {}
    # the payload rides only when every shard built it; the seeding table
    # also needs one of the same shape on every shard (small shards skip
    # it and seed randomly inside the compressed loop)
    if (len(payload["nbr_codes"]) == len(comms.local)
            and all(x is not None for k in _PAYLOAD_CORE
                    for x in payload[k])):
        opt = {k: payload[k] for k in _PAYLOAD_CORE}
        cents = payload["centroids"]
        if (all(c is not None for c in cents)
                and len({tuple(c.shape) for c in cents}) == 1):
            opt["centroids"] = cents
            opt["centroid_reps"] = payload["centroid_reps"]
    return ShardedCagraIndex(ds_parts, g_parts, n, comms, **opt)


@traced("distributed.cagra::search")
def search(index: ShardedCagraIndex, queries, k: int,
           params: sl.CagraSearchParams = sl.CagraSearchParams(),
           res: Optional[Resources] = None, health=None,
           device: Optional[DeviceLike] = None, stats: Optional[dict] = None):
    """Every shard walks its local graph; the merge re-selects the
    candidates exactly → a
    :class:`~raft_tpu_torch.distributed._sharding.SearchResult` of
    (distances (q, k), GLOBAL row ids (q, k)). ``stats``, when given,
    receives the resolved ``mode`` and each shard's ``hops``."""
    resources_for(device, res)
    comms = index.comms
    queries = torch.as_tensor(queries).to(torch.float32)
    if queries.ndim != 2 or queries.shape[1] != index.dim:
        raise ValueError(f"queries must be (q, {index.dim})")
    rows = index.rows_per_shard
    itopk = int(min(params.itopk_size, rows))
    if not 0 < k <= itopk:
        raise ValueError(f"k={k} must be in (0, itopk_size={itopk}]")
    width = int(params.search_width)
    max_iter = int(params.max_iterations) or max(16, itopk // width)
    min_iter = int(min(params.min_iterations, max_iter))
    has_payload = index.nbr_codes is not None
    p = index.proj[0].shape[1] if has_payload else index.dim
    # allow_fused=False: shard bodies run the unfused loop, as in the JAX
    # package ("fused" downgrades, "auto" resolves to compressed)
    mode, rt = sl._resolve_traversal(
        params, has_payload, int(k), itopk, size=rows, width=width,
        degree=index.graph_degree, proj_dim=p,
        on_cuda=comms.devices[0].type == "cuda", allow_fused=False)
    n_rand = int(max(1, params.num_random_samplings))
    report = probe_shards("cagra", comms.size, index.n_total, health=health)
    hops = []

    def body(rank, i):
        dev = index.dataset[i].device
        qs = queries.to(dev)
        (gen,) = seeded_generators(params.seed, 1, dev)
        if mode == "compressed":
            vals, local, h = sl._search_impl_compressed(
                index.shard_index(i), qs, gen, int(k), itopk, width, max_iter,
                min_iter, n_rand, rt)
        else:
            vals, local, h = sl._search_impl(
                index.dataset[i], index.graph[i], qs, gen, int(k), itopk,
                width, max_iter, min_iter, n_rand)
        hops.append(h)
        gids = torch.where(local >= 0, rank * rows + local,
                           torch.full_like(local, -1)).to(torch.int32)
        # sentinel rows score ~1e36 already; also mask ids past the true
        # row count
        bad = (gids < 0) | (gids >= index.n_total)
        return (torch.where(bad, torch.full_like(vals, float("inf")), vals),
                torch.where(bad, torch.full_like(gids, -1), gids))

    out = comms.map(body, list(range(len(comms.local))))
    vals, ids = blank_dead(comms, report, [o[0] for o in out],
                           [o[1] for o in out])
    mv, mi = merge_shards(comms, vals, ids, int(k))
    if stats is not None:
        stats.update(mode=mode, refine_topk=rt, hops=hops)
    return SearchResult(mv[0], mi[0], coverage=report.coverage,
                        degraded=report.degraded, lost_shards=report.dropped)
