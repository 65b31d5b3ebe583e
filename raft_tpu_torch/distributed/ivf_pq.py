"""Multi-shard IVF-PQ: globally trained quantizers, row-sharded code
lists, a query-tiled shard scan over the int8 decoded cache (counterpart
of ``raft_tpu/distributed/ivf_pq.py``).

* **Replicated**: the coarse centers (data-sharded k-means), the rotation
  and the per-subspace (or per-list) codebooks, trained on a subsample of
  at most 65,536 rows; every shard encodes and probes identically.
* **Per shard**: its rows' packed PQ codes, the scan bias (‖R·c_l‖² +
  b_sum for L2, b_sum otherwise; +inf at padding) and the int8 residual
  cache at the replicated scale max|codebooks|/127 (exact and the same on
  every shard with no collective). The center term −2⟨q, R·c_l⟩ rides
  the merge's exact per-pair constant instead of the cache.
* **Search**: one plan a query tile from the per-list maximum fill, each
  shard's scan of its cache (K1 on a card), the butterfly merge; re-rank
  with ``neighbors.refine`` for the headline configuration (the candidate
  ids are global).
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
from raft_tpu_torch.distributed.ivf_flat import (_normalize, km_metric_of,
                                                 train_centers)
from raft_tpu_torch.neighbors import _packing
from raft_tpu_torch.neighbors import ivf_pq as sl
from raft_tpu_torch.neighbors.ivf_pq import IvfPqParams
from raft_tpu_torch.ops import distance as dist_mod
from raft_tpu_torch.ops.linalg import make_rotation_matrix, rotate_rows


@dataclass
class ShardedIvfPqIndex:
    """Row-sharded IVF-PQ: replicated quantizers; each local shard's
    packed code lists, GLOBAL row ids, scan bias and int8 decoded cache."""

    centers: torch.Tensor            # (n_lists, dim), replicated
    rotation: torch.Tensor           # (rot_dim, rot_dim), replicated
    codebooks: torch.Tensor          # (pq_dim | n_lists, n_codes, dsub)
    list_codes: List[torch.Tensor]   # (n_lists, mls, code bytes) uint8
    list_ids: List[torch.Tensor]     # (n_lists, mls) int32
    bias: List[torch.Tensor]         # (n_lists, mls) fp32
    decoded: List[torch.Tensor]      # (n_lists, mls, rot_dim) int8
    decoded_scale: float             # replicated dequant scale
    metric: str
    pq_bits: int
    n_total: int
    comms: C.Comms
    lens_max: np.ndarray             # host (n_lists,) max fill across shards

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


@traced("distributed.ivf_pq::build")
def build(dataset, params: IvfPqParams = IvfPqParams(),
          comms: Optional[C.Comms] = None, res: Optional[Resources] = None,
          device: Optional[DeviceLike] = None) -> ShardedIvfPqIndex:
    """Global quantizers, then each shard's assign + spill, and its
    encode, pack, bias and int8 decode."""
    res = resources_for(device, res)
    comms = comms or C.make_comms(res)
    world = comms.size
    dev0 = comms.devices[0]
    work = torch.as_tensor(dataset).to(device=dev0, dtype=torch.float32)
    n, dim = work.shape
    if params.n_lists * world > n:
        raise ValueError(f"n_lists={params.n_lists} x {world} shards > "
                         f"n_rows={n}")
    cluster = params.codebook_kind == "cluster"
    pq_dim = params.pq_dim or sl._auto_pq_dim(dim)
    dsub = -(-dim // pq_dim)
    rot_dim = pq_dim * dsub
    n_codes = 1 << params.pq_bits
    if params.metric == "cosine":
        work = _normalize(work)
    km_metric = km_metric_of(params.metric)
    centers = train_centers(work, params.n_lists, params, comms, res)

    # the replicated rotation and codebooks, from one subsample
    g_rot, g_cb, g_sub = kmeans_balanced.seeded_generators(params.seed, 3,
                                                           dev0)
    rotation = make_rotation_matrix(g_rot, rot_dim, dev0)
    cb_rows = min(n, 65536)
    sub = work[torch.randint(0, n, (cb_rows,), generator=g_sub, device=dev0)]
    _, sub_labels = kmeans_balanced._assign(sub, centers, km_metric,
                                            res.workspace_bytes)
    resid = rotate_rows(sub - centers[sub_labels], rotation)
    resid3 = resid.reshape(cb_rows, pq_dim, dsub)
    if cluster:
        codebooks = sl._train_codebooks_cluster(
            resid3, sub_labels, g_cb, n_codes, params.codebook_n_iters,
            params.n_lists)
    else:
        codebooks = sl._train_codebooks(
            resid3.transpose(0, 1).contiguous(), g_cb, n_codes,
            params.codebook_n_iters, res.workspace_bytes)

    work_sh, gids_sh, rows_per = sh.shard_rows(work, comms)
    del work
    group = params.group_size or _packing.auto_group_size(
        rows_per, params.n_lists, floor=128)
    cap = params.list_size_cap
    if cap < 0:
        cap = _packing.auto_list_cap(rows_per, params.n_lists, group)
    n_lists = params.n_lists
    labels_sh, counts_np = sh.assign_phase(work_sh, gids_sh, centers,
                                           km_metric, cap, n_lists, comms,
                                           res.workspace_bytes)
    mls = sh.round_mls(int(counts_np.max()), group)
    # the residual-only cache's scale: exact and the same on every shard
    scale = float(torch.clamp(codebooks.abs().max(), min=1e-30) / 127.0)
    l2 = params.metric in ("sqeuclidean", "euclidean")
    code_w = sl.packed_width(pq_dim, params.pq_bits)

    def pack(_rank, rows, ids, labels):
        dev = rows.device
        c, rot, cb = centers.to(dev), rotation.to(dev), codebooks.to(dev)
        safe = torch.clamp(labels, max=n_lists - 1)
        raw = sl._encode_rows(
            rotate_rows(rows - c[safe], rot).reshape(-1, pq_dim, dsub), safe,
            cb, cluster)
        codes = sl.pack_codes(raw, params.pq_bits)
        lc, li = sh.scatter_pack(
            labels,
            [(torch.zeros((n_lists, mls, code_w), dtype=torch.uint8,
                          device=dev), codes),
             (torch.full((n_lists, mls), -1, dtype=torch.int32, device=dev),
              ids)],
            n_lists, mls)
        b_sum = sl._compute_b_sum(c, rot, cb, lc, li, params.metric, pq_dim,
                                  params.pq_bits, cluster)
        # fold the coarse-center norm in once (b_sum is +inf at padding)
        bias = (sl._center_rot_sqnorm(c, rot)[:, None] + b_sum if l2
                else b_sum)
        dec = sl._decode_lists_scaled(cb, lc, torch.tensor(scale, device=dev),
                                      pq_dim, params.pq_bits, cluster)
        return lc, li, bias.contiguous(), dec

    packed = comms.map(pack, work_sh, gids_sh, labels_sh)
    return ShardedIvfPqIndex(
        centers, rotation, codebooks, [p[0] for p in packed],
        [p[1] for p in packed], [p[2] for p in packed],
        [p[3] for p in packed], scale, params.metric, params.pq_bits, n,
        comms, counts_np.max(axis=0).astype(np.int32))


@traced("distributed.ivf_pq::search")
def search(index: ShardedIvfPqIndex, queries, k: int, n_probes: int = 20,
           res: Optional[Resources] = None, health=None,
           device: Optional[DeviceLike] = None):
    """Sharded IVF-PQ search → PQ-approximate global (distances (q, k),
    row ids (q, k)) as a
    :class:`~raft_tpu_torch.distributed._sharding.SearchResult`; re-rank
    with ``neighbors.refine`` for the headline configuration."""
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
    # one gemm feeds the coarse ranking and the exact per-pair center term
    probes, qr, pair_const = sl._pq_probe_prep(
        queries, index.centers.to(dev0), index.rotation.to(dev0), n_probes,
        "exact", l2)
    qr_scaled = qr * index.decoded_scale
    # a truncated cache drops the same rotated tail from the queries
    width = index.decoded[0].shape[-1]
    if width < qr_scaled.shape[-1]:
        qr_scaled = qr_scaled[:, :width]
    vals, ids, report = sh.tiled_search(
        qr_scaled, probes, index.lens_max, index.n_lists, int(k),
        index.comms, -2.0 if l2 else -1.0,
        dense=sh.search_engine_dense(index.comms, index.max_list_size),
        data=index.decoded, ids_arr=index.list_ids, bias=index.bias,
        pair_const=pair_const, algo="ivf_pq", n_total=index.n_total,
        health=health, workspace_bytes=res.workspace_bytes)
    inf = torch.full_like(vals, float("inf"))
    if l2:
        # ‖Rq‖² == ‖q‖²: the rotation is orthogonal, the padding adds 0
        vals = torch.clamp(vals + dist_mod.sqnorm(queries)[:, None], min=0.0)
        if index.metric == "euclidean":
            vals = torch.sqrt(vals)
        vals = torch.where(ids >= 0, vals, inf)
    else:
        vals = torch.where(ids >= 0, -vals, -inf)
    if index.metric == "cosine":
        vals = torch.where(ids >= 0, 1.0 - vals, inf)
    return sh.SearchResult(vals, ids, coverage=report.coverage,
                           degraded=report.degraded,
                           lost_shards=report.dropped)
