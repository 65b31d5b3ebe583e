"""Multi-shard IVF-BQ: globally trained centers and rotation, row-sharded
packed 1-bit (or multi-bit) code lists (counterpart of
``raft_tpu/distributed/ivf_bq.py``).

* **Replicated**: the coarse centers (the data-sharded balanced k-means,
  behind the shard-health fit gate) and the rotation: BQ has no
  codebooks.
* **Per shard**: its rows' packed codes, ids and the two correction planes
  (scale f, additive bias), encoded by the single-index build's
  ``_encode_math``, so the estimator cannot drift between the two.
* **Search**: ``scan="bq"`` through the shared tiled search (K2 on a card,
  the dense packed scan on the CPU), the butterfly merge, the single-index
  finalize.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.comms import comms as C
from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.distributed import _sharding as sh
from raft_tpu_torch.distributed.ivf_flat import _normalize, km_metric_of
from raft_tpu_torch.neighbors import _packing
from raft_tpu_torch.neighbors import ivf_bq as sl
from raft_tpu_torch.neighbors.ivf_bq import IvfBqParams
from raft_tpu_torch.neighbors.ivf_flat import _finalize_ragged
from raft_tpu_torch.ops import distance as dist_mod
from raft_tpu_torch.ops import linalg


@dataclass
class ShardedIvfBqIndex:
    """Row-sharded IVF-BQ: replicated centers and rotation; each local
    shard's packed codes, GLOBAL row ids, correction scale and scan bias
    (+inf at padding)."""

    centers: torch.Tensor          # (n_lists, dim), replicated
    rotation: torch.Tensor         # (rot_dim, rot_dim) | (rot_dim,) signs
    list_codes: List[torch.Tensor]  # (n_lists, mls, bits·rot_dim/8) uint8
    list_ids: List[torch.Tensor]   # (n_lists, mls) int32
    list_scale: List[torch.Tensor]  # (n_lists, mls) fp32
    bias: List[torch.Tensor]       # (n_lists, mls) fp32
    metric: str
    n_total: int
    comms: C.Comms
    lens_max: np.ndarray           # host (n_lists,) max fill across shards
    bits: int = 1
    rotation_kind: str = "dense"

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def rot_dim(self) -> int:
        return self.rotation.shape[0]

    @property
    def max_list_size(self) -> int:
        return self.list_codes[0].shape[1]


@traced("distributed.ivf_bq::build")
def build(dataset, params: IvfBqParams = IvfBqParams(),
          comms: Optional[C.Comms] = None, res: Optional[Resources] = None,
          device: Optional[DeviceLike] = None) -> ShardedIvfBqIndex:
    """Global centers (distributed balanced k-means) and rotation, then
    each shard's assign + spill, and its encode + pack at the common
    padded list size."""
    from raft_tpu_torch.distributed import kmeans as dkm

    res = resources_for(device, res)
    comms = comms or C.make_comms(res)
    world = comms.size
    dev0 = comms.devices[0]
    work = torch.as_tensor(dataset).to(device=dev0, dtype=torch.float32)
    n, dim = work.shape
    if params.n_lists * world > n:
        raise ValueError(f"n_lists={params.n_lists} x {world} shards > "
                         f"n_rows={n}")
    rot_dim = sl.auto_rot_dim(dim, params.rotation_kind)
    nb = (params.bits * rot_dim) // 8
    if params.metric == "cosine":
        work = _normalize(work)
    km_metric = km_metric_of(params.metric)
    centers, _, _ = dkm.fit_balanced(
        work, params.n_lists,
        kmeans_balanced.KMeansBalancedParams(n_iters=params.kmeans_n_iters,
                                             metric=km_metric,
                                             seed=params.seed),
        comms=comms, res=res)
    # the replicated rotation: every shard derives it from the seed
    (g_rot,) = kmeans_balanced.seeded_generators(params.seed ^ 0x0B17, 1,
                                                 dev0)
    rotation = sl._make_rotation(g_rot, rot_dim, params.rotation_kind, dev0)

    work_sh, gids_sh, rows_per = sh.shard_rows(work, comms)
    del work
    cap = params.list_size_cap
    if cap < 0:
        cap = _packing.auto_list_cap(rows_per, params.n_lists, sl._GROUP)
    n_lists = params.n_lists
    labels_sh, counts_np = sh.assign_phase(work_sh, gids_sh, centers,
                                           km_metric, cap, n_lists, comms,
                                           res.workspace_bytes)
    mls = sh.round_mls(int(counts_np.max()), sl._GROUP)
    l2 = params.metric in ("sqeuclidean", "euclidean")

    def pack(_rank, rows, ids, labels):
        dev = rows.device
        c, rot = centers.to(dev), rotation.to(dev)
        rc = linalg.rotate_rows(c, rot, params.rotation_kind)
        c2 = dist_mod.sqnorm(c)
        safe = torch.clamp(labels, max=n_lists - 1)
        codes, scale, row_bias = sl._encode_math(
            rows, safe, c, rot, rc, c2, l2, params.bits,
            params.rotation_kind)
        lc, li, lscale, lbias = sh.scatter_pack(
            labels,
            [(torch.zeros((n_lists, mls, nb), dtype=torch.uint8, device=dev),
              codes),
             (torch.full((n_lists, mls), -1, dtype=torch.int32, device=dev),
              ids),
             (torch.zeros((n_lists, mls), dtype=torch.float32, device=dev),
              scale),
             (torch.zeros((n_lists, mls), dtype=torch.float32, device=dev),
              row_bias)],
            n_lists, mls)
        lbias = torch.where(li >= 0, lbias,
                            torch.full_like(lbias, float("inf")))
        return lc, li, lscale, lbias.contiguous()

    packed = comms.map(pack, work_sh, gids_sh, labels_sh)
    return ShardedIvfBqIndex(
        centers, rotation, [p[0] for p in packed], [p[1] for p in packed],
        [p[2] for p in packed], [p[3] for p in packed], params.metric, n,
        comms, counts_np.max(axis=0).astype(np.int32), params.bits,
        params.rotation_kind)


@traced("distributed.ivf_bq::search")
def search(index: ShardedIvfBqIndex, queries, k: int, n_probes: int = 20,
           res: Optional[Resources] = None, health=None,
           device: Optional[DeviceLike] = None):
    """Sharded IVF-BQ search → ESTIMATED global (distances (q, k), row
    ids (q, k)) as a
    :class:`~raft_tpu_torch.distributed._sharding.SearchResult`; re-rank
    with ``neighbors.refine`` for the recall-gated configuration."""
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
    probes, qr, pair_const = sl._bq_search_prep(
        queries, index.centers.to(dev0), index.rotation.to(dev0), n_probes,
        "exact", l2, index.bits, index.rotation_kind)
    vals, ids, report = sh.tiled_search(
        qr, probes, index.lens_max, index.n_lists, int(k), index.comms,
        -2.0 if l2 else -1.0,
        dense=sh.search_engine_dense(index.comms, index.max_list_size),
        data=index.list_codes, ids_arr=index.list_ids, bias=index.bias,
        pair_const=pair_const, algo="ivf_bq", n_total=index.n_total,
        health=health, scale=index.list_scale, scan="bq",
        workspace_bytes=res.workspace_bytes)
    # the single-index finalize: one copy of the distance conventions
    vals, ids = _finalize_ragged(vals, ids, queries, index.metric)
    return sh.SearchResult(vals, ids, coverage=report.coverage,
                           degraded=report.degraded,
                           lost_shards=report.dropped)
