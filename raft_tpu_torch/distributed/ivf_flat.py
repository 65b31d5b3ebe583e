"""Multi-shard IVF-Flat: globally trained centers, row-sharded lists, a
query-tiled shard scan and merge (counterpart of
``raft_tpu/distributed/ivf_flat.py``; the raft-dask model of one index a
worker and collectives for the merge).

* **build** — the coarse quantizer is trained once by the data-sharded
  k-means (every shard agrees on list ids); then each shard assigns and
  spills its rows, one all-gather of the per-shard list counts fixes the
  common padded list size, and each shard packs its lists: one
  (n_lists, mls, dim) fp32 block a shard.
* **search** — replicated queries, one plan a query tile from the per-list
  maximum fill across shards, each shard's scan (K1 on a card,
  :mod:`~raft_tpu_torch.distributed._sharding`), the butterfly merge.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from raft_tpu_torch.comms import comms as C
from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.distributed import _sharding as sh
from raft_tpu_torch.neighbors import _packing
from raft_tpu_torch.neighbors.ivf_flat import (IvfFlatParams,
                                               _coarse_probes,
                                               _finalize_ragged)
from raft_tpu_torch.ops import distance as dist_mod


def _normalize(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                           min=1e-30)


def km_metric_of(metric: str) -> str:
    return ("inner_product" if metric in ("cosine", "inner_product")
            else "sqeuclidean")


def train_centers(work, n_lists: int, params, comms, res):
    """The global coarse quantizer of IVF-Flat and IVF-PQ: the
    data-sharded k-means (normalized for the inner-product metrics)."""
    from raft_tpu_torch.cluster.kmeans import KMeansParams
    from raft_tpu_torch.distributed import kmeans as dkm

    out, _ = dkm.fit(work, KMeansParams(n_clusters=n_lists,
                                        max_iter=params.kmeans_n_iters,
                                        seed=params.seed),
                     comms=comms, res=res)
    centers = out.centroids
    if params.metric in ("cosine", "inner_product"):
        centers = _normalize(centers)
    return centers


@dataclass
class ShardedIvfFlatIndex:
    """Row-sharded IVF-Flat: one coarse quantizer, each local shard's
    padded lists (``list_data`` (n_lists, mls, dim) fp32, ``list_ids``
    GLOBAL row ids, -1 at padding, ``bias`` the per-entry scan term: ‖x‖²
    for L2, 0 for the inner-product metrics, +inf at padding)."""

    centers: torch.Tensor          # (n_lists, dim), replicated
    list_data: List[torch.Tensor]
    list_ids: List[torch.Tensor]
    bias: List[torch.Tensor]
    metric: str
    n_total: int
    comms: C.Comms
    lens_max: np.ndarray           # host (n_lists,) max fill across shards

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def max_list_size(self) -> int:
        return self.list_data[0].shape[1]


@traced("distributed.ivf_flat::build")
def build(dataset, params: IvfFlatParams = IvfFlatParams(),
          comms: Optional[C.Comms] = None, res: Optional[Resources] = None,
          device: Optional[DeviceLike] = None) -> ShardedIvfFlatIndex:
    """Global centers (distributed k-means), then each shard's assign +
    spill and pack at the common padded list size."""
    res = resources_for(device, res)
    comms = comms or C.make_comms(res)
    world = comms.size
    work = torch.as_tensor(dataset).to(device=comms.devices[0],
                                       dtype=torch.float32)
    n, dim = work.shape
    if params.n_lists * world > n:
        raise ValueError(f"n_lists={params.n_lists} x {world} shards > "
                         f"n_rows={n}")
    if params.metric == "cosine":
        work = _normalize(work)
    km_metric = km_metric_of(params.metric)
    centers = train_centers(work, params.n_lists, params, comms, res)

    work_sh, gids_sh, rows_per = sh.shard_rows(work, comms)
    del work
    group = params.group_size or _packing.auto_group_size(rows_per,
                                                          params.n_lists)
    cap = params.list_size_cap
    if cap < 0:
        cap = _packing.auto_list_cap(rows_per, params.n_lists, group)
    n_lists = params.n_lists
    labels_sh, counts_np = sh.assign_phase(work_sh, gids_sh, centers,
                                           km_metric, cap, n_lists, comms,
                                           res.workspace_bytes)
    mls = sh.round_mls(int(counts_np.max()), group)
    l2 = params.metric in ("sqeuclidean", "euclidean")

    def pack(_rank, rows, ids, labels):
        dev = rows.device
        ld, li = sh.scatter_pack(
            labels,
            [(torch.zeros((n_lists, mls, dim), dtype=torch.float32,
                          device=dev), rows),
             (torch.full((n_lists, mls), -1, dtype=torch.int32, device=dev),
              ids)],
            n_lists, mls)
        base = (dist_mod.sqnorm(ld, dim=2) if l2
                else torch.zeros((n_lists, mls), device=dev))
        bias = torch.where(li >= 0, base,
                           torch.full_like(base, float("inf")))
        return ld, li, bias.to(torch.float32).contiguous()

    packed = comms.map(pack, work_sh, gids_sh, labels_sh)
    return ShardedIvfFlatIndex(
        centers, [p[0] for p in packed], [p[1] for p in packed],
        [p[2] for p in packed], params.metric, n, comms,
        counts_np.max(axis=0).astype(np.int32))


@traced("distributed.ivf_flat::search")
def search(index: ShardedIvfFlatIndex, queries, k: int, n_probes: int = 20,
           res: Optional[Resources] = None, health=None,
           device: Optional[DeviceLike] = None):
    """Sharded search → a
    :class:`~raft_tpu_torch.distributed._sharding.SearchResult` of global
    (distances (q, k), row ids (q, k)), with ``coverage`` / ``degraded``
    when shards were dropped (``health`` defaults to the process
    registry)."""
    res = resources_for(device, res)
    dev0 = index.comms.devices[0]
    queries = torch.as_tensor(queries).to(device=dev0, dtype=torch.float32)
    if queries.shape[1] != index.dim:
        raise ValueError(f"query dim {queries.shape[1]} != index dim "
                         f"{index.dim}")
    if index.metric == "cosine":
        queries = _normalize(queries)
    n_probes = int(min(n_probes, index.n_lists))
    l2 = index.metric in ("sqeuclidean", "euclidean")
    probes = _coarse_probes(queries, index.centers.to(dev0), n_probes,
                            index.metric, "exact", res.compute_dtype)
    vals, ids, report = sh.tiled_search(
        queries, probes, index.lens_max, index.n_lists, int(k), index.comms,
        -2.0 if l2 else -1.0,
        dense=sh.search_engine_dense(index.comms, index.max_list_size),
        data=index.list_data, ids_arr=index.list_ids, bias=index.bias,
        algo="ivf_flat", n_total=index.n_total, health=health,
        workspace_bytes=res.workspace_bytes)
    vals, ids = _finalize_ragged(vals, ids, queries, index.metric)
    return sh.SearchResult(vals, ids, coverage=report.coverage,
                           degraded=report.degraded,
                           lost_shards=report.dropped)
