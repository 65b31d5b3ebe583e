"""Sharded exact kNN: the dataset row-sharded over the communicator, a
cross-shard merge (counterpart of ``raft_tpu/distributed/brute_force.py``).

Every shard scans its rows against the replicated queries and keeps its
local top-k; :func:`~raft_tpu_torch.distributed._sharding.merge_shards`
exchanges the candidates and re-selects (knn_merge_parts.cuh:140).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from raft_tpu_torch.comms import comms as C
from raft_tpu_torch.core.interruptible import check_interrupt
from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.distributed._sharding import (SearchResult, blank_dead,
                                                  merge_shards, probe_shards)
from raft_tpu_torch.neighbors.brute_force import _MAX_METRICS, _tile_distances
from raft_tpu_torch.ops import distance as dist
from raft_tpu_torch.ops.select_k import select_k

_NORM_METRICS = ("sqeuclidean", "euclidean", "cosine")


@dataclass
class ShardedBruteForceIndex:
    """Row-sharded exact-search index: ``dataset`` holds each local shard's
    block of the padded rows (``ceil(n / world)`` each), ``norms`` their
    squared norms for the metrics that use them; ``n_total`` is the true
    row count."""

    dataset: List[torch.Tensor]
    norms: Optional[List[torch.Tensor]]
    metric: str
    metric_arg: float
    n_total: int
    comms: C.Comms

    @property
    def dim(self) -> int:
        return self.dataset[0].shape[1]

    @property
    def size(self) -> int:
        return self.n_total


@traced("distributed.brute_force::build")
def build(dataset, metric: str = "sqeuclidean", metric_arg: float = 2.0,
          comms: Optional[C.Comms] = None, res: Optional[Resources] = None,
          device: Optional[DeviceLike] = None) -> ShardedBruteForceIndex:
    """Shard the rows over the communicator and precompute the norms
    (brute_force-inl.cuh:337 per rank)."""
    res = resources_for(device, res)
    comms = comms or C.make_comms(res)
    metric = dist.canonical_metric(metric)
    data = torch.as_tensor(dataset)
    n = data.shape[0]
    parts, _ = C.shard_padded(data, comms)
    norms = ([dist.sqnorm(p) for p in parts] if metric in _NORM_METRICS
             else None)
    return ShardedBruteForceIndex(parts, norms, metric, float(metric_arg), n,
                                  comms)


@traced("distributed.brute_force::search")
def search(index: ShardedBruteForceIndex, queries, k: int, filter=None,
           select_algo: str = "exact", res: Optional[Resources] = None,
           health=None, device: Optional[DeviceLike] = None):
    """Sharded exact kNN → a
    :class:`~raft_tpu_torch.distributed._sharding.SearchResult` of
    (distances (q, k), global ids (q, k)), the largest values for inner
    product; ``coverage`` / ``degraded`` when shards were dropped.
    ``filter``: a :class:`~raft_tpu_torch.core.bitset.Bitset` of
    ``n_total`` bits."""
    res = resources_for(device, res)
    comms = index.comms
    queries = torch.as_tensor(queries)
    if queries.shape[1] != index.dim:
        raise ValueError(f"query dim {queries.shape[1]} != index dim "
                         f"{index.dim}")
    if not 0 < k <= index.n_total:
        raise ValueError(f"k={k} out of range for n={index.n_total}")
    if filter is not None and filter.n_bits != index.n_total:
        raise ValueError(f"filter covers {filter.n_bits} bits but index has "
                         f"{index.n_total} rows")
    metric = index.metric
    select_min = metric not in _MAX_METRICS
    bad = float("inf") if select_min else float("-inf")
    compute_dtype = (res.compute_dtype if metric in dist.EXPANDED_METRICS
                     else None)
    report = probe_shards("brute_force", comms.size, index.n_total,
                          health=health)
    norms = index.norms or [None] * len(index.dataset)
    # query tiles sized from the workspace: a shard's (tile, rows) block
    # with its select; each query still selects over all its shard's rows
    rows_per = index.dataset[0].shape[0]
    q_tile = int(max(1, min(queries.shape[0],
                            res.workspace_bytes // max(1, rows_per * 16))))
    out_v, out_i = [], []
    for s in range(0, queries.shape[0], q_tile):
        check_interrupt()
        v, i = _search_tile(index, queries[s:s + q_tile], k, filter,
                            select_algo, norms, report, compute_dtype,
                            select_min, bad)
        out_v.append(v)
        out_i.append(i)
    return SearchResult(torch.cat(out_v), torch.cat(out_i),
                        coverage=report.coverage, degraded=report.degraded,
                        lost_shards=report.dropped)


def _search_tile(index, queries, k: int, filter, select_algo: str, norms,
                 report, compute_dtype, select_min: bool, bad: float):
    """One query tile: every shard's local top-k over all its rows, dead
    shards blanked, the merge → (vals, ids) on the first shard's device."""
    comms = index.comms
    metric = index.metric

    def body(rank, shard, shard_norms):
        dev = shard.device
        rows = shard.shape[0]
        qs = queries.to(device=dev)
        gids = rank * rows + torch.arange(rows, dtype=torch.int32, device=dev)
        qn = dist.sqnorm(qs.to(torch.float32)) if metric in _NORM_METRICS \
            else None
        d = _tile_distances(qs, qn, shard, shard_norms, metric,
                            index.metric_arg, compute_dtype)
        valid = gids < index.n_total
        if filter is not None:
            valid = valid & filter.to(dev).test(gids)
        d = torch.where(valid[None, :], d, torch.full_like(d, bad))
        if k > rows:
            # k is checked against the global n: pad the local candidates
            d = torch.nn.functional.pad(d, (0, k - rows), value=bad)
            gids = torch.nn.functional.pad(gids, (0, k - rows), value=-1)
        vals, sel = select_k(d, k, select_min=select_min, algo=select_algo)
        ids = gids[sel.to(torch.int64)]
        return vals, torch.where(vals == bad, torch.full_like(ids, -1), ids)

    out = comms.map(body, index.dataset, norms)
    vals, ids = blank_dead(comms, report, [o[0] for o in out],
                           [o[1] for o in out], bad)
    mv, mi = merge_shards(comms, vals, ids, int(k), select_min)
    return mv[0], mi[0]
