"""Exact k-NN by brute force (counterpart of
``raft_tpu/neighbors/brute_force.py``) under every metric of
:data:`raft_tpu_torch.ops.distance.ALL_METRICS`.

The search is tiled over the dataset — 10k queries against 1M rows would be
40 GB of fp32 distances — with a running top-k merge: each tile's distances
come from one ``torch.matmul`` (full fp32, TF32 off) for the expanded
metrics or one broadcast block for the elementwise ones, its k best by a
stable sort, and a stable merge with the running result, so ties go to the
lowest row id as in the JAX package. ``filter`` excludes rows by id. This
is the ground truth of the port, filtered recall's too.

The tile size is OOM-adaptive, as in the JAX package: a search whose
tile's blocks do not fit on the card (``torch.cuda.OutOfMemoryError``)
runs again at half the tile, down to a floor
(``resilience.degrade_on_oom``); the tile only partitions the scan, so
every size gives the same result.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from raft_tpu_torch import obs
from raft_tpu_torch.obs import compile as obs_compile
from raft_tpu_torch.obs import roofline as obs_roofline
from raft_tpu_torch.obs.costmodel import dtype_name
from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.ops import distance as dist
from raft_tpu_torch.ops.select_k import select_k
from raft_tpu_torch.resilience import degrade_on_oom, faultpoint
from raft_tpu_torch.utils.tiling import ceil_div

# metrics where larger is better (the search keeps the largest)
_MAX_METRICS = frozenset({"inner_product"})
_NORM_METRICS = frozenset({"sqeuclidean", "euclidean", "cosine"})


@dataclass
class BruteForceIndex:
    dataset: torch.Tensor            # (n, dim), any real dtype
    norms: Optional[torch.Tensor]    # (n,) fp32 squared norms (L2, cosine)
    metric: str = "sqeuclidean"
    metric_arg: float = 2.0          # minkowski's p

    @property
    def size(self) -> int:
        return self.dataset.shape[0]

    @property
    def dim(self) -> int:
        return self.dataset.shape[1]


@traced("brute_force::build")
def build(dataset, metric: str = "sqeuclidean", metric_arg: float = 2.0,
          res: Optional[Resources] = None,
          device: Optional[DeviceLike] = None) -> BruteForceIndex:
    """Keep the dataset on the device, with its row norms for the metrics
    that use them."""
    metric = dist.canonical_metric(metric)
    res = resources_for(device, res)
    data = torch.as_tensor(dataset).to(res.device)
    norms = dist.sqnorm(data) if metric in _NORM_METRICS else None
    return BruteForceIndex(data, norms, metric, float(metric_arg))


def _tile_distances(queries, qn, tile, tile_norms, metric: str,
                    metric_arg: float, compute_dtype):
    """Distances of all queries against one dataset tile, with the query
    norms ``qn`` hoisted out of the tile loop."""
    if metric in ("sqeuclidean", "euclidean"):
        ip = dist.matmul_t(queries, tile, compute_dtype)
        d = torch.clamp(qn[:, None] + tile_norms[None, :] - 2.0 * ip, min=0.0)
        return torch.sqrt(d) if metric == "euclidean" else d
    if metric == "cosine":
        ip = dist.matmul_t(queries, tile, compute_dtype)
        return 1.0 - ip / torch.clamp(torch.sqrt(qn)[:, None]
                                      * torch.sqrt(tile_norms)[None, :],
                                      min=1e-30)
    return dist.metric_block(queries, tile, metric, metric_arg,
                             compute_dtype)


@traced("brute_force::search")
def search(index: BruteForceIndex, queries, k: int, filter=None,
           tile_rows: Optional[int] = None, select_algo: str = "exact",
           res: Optional[Resources] = None,
           device: Optional[DeviceLike] = None):
    """Exact k-NN → (distances (q, k) fp32, indices (q, k) int32); the
    largest values for inner product, the smallest otherwise. ``filter``, a
    :class:`~raft_tpu_torch.core.bitset.Bitset` of ``index.size`` bits,
    excludes rows; ids are -1 (values ±inf) where fewer than k rows
    pass. ``select_algo`` picks each tile's select as the JAX package's
    does (:func:`~raft_tpu_torch.ops.select_k.select_k`: "exact", "iter",
    "approx" or "packed", the last over each tile's real columns); the
    merge across tiles is exact."""
    res = resources_for(device, res)
    if index.dataset.device != res.device:
        raise ValueError(f"index lives on {index.dataset.device}, search "
                         f"runs on {res.device}")
    queries = torch.as_tensor(queries).to(device=res.device,
                                          dtype=torch.float32)
    n = index.size
    q = queries.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"k={k} out of range for n={n}")
    if filter is not None and filter.n_bits != n:
        raise ValueError(f"filter covers {filter.n_bits} bits but index has "
                         f"{n} rows")
    if select_algo not in ("exact", "iter", "approx", "packed"):
        raise ValueError(f"unknown select_algo {select_algo!r}")
    expanded = index.metric in dist.EXPANDED_METRICS
    if tile_rows is None:
        # the (q, tile) distance block, its sorted copy and int64 order;
        # an elementwise metric also broadcasts a (q, tile, dim) block
        per_col = q * 16 + index.dim * 4 + (0 if expanded
                                            else q * index.dim * 4)
        tile_rows = int(min(n, max(k, res.workspace_bytes // max(1, per_col))))
    tile_rows = max(min(int(tile_rows), n), k)
    if obs.enabled():
        obs.add("brute_force.search.queries", q)
        obs.add("brute_force.search.rows_scanned", q * n)
        obs.add("brute_force.search.tiles", ceil_div(n, tile_rows))
        # the exact scan is the roofline's calibration anchor: one dense
        # gemm, no padding
        obs_roofline.note_dispatch(
            "brute_force.search",
            {"q": q, "n": n, "dim": index.dim, "k": int(k),
             "dtype": dtype_name(index.dataset.dtype)})

    def attempt(tr):
        faultpoint("brute_force.search")
        obs_compile.trace_event(
            "brute_force.search", queries=queries, dataset=index.dataset,
            norms=index.norms, filter=filter,
            static={"k": int(k), "metric": index.metric,
                    "metric_arg": index.metric_arg, "tile_rows": int(tr),
                    "select_algo": select_algo,
                    "compute_dtype": res.compute_dtype})
        return _search_tiles(index, queries, int(k), filter, int(tr),
                             select_algo, res)

    # the tile only partitions the scan (any size >= k is exact), so an
    # OOM retries at half the tile down to the floor
    floor = min(tile_rows, max(min(n, int(k)), 128))
    return degrade_on_oom(attempt, tile_rows, floor=floor,
                          site="brute_force.search")


def _search_tiles(index: BruteForceIndex, queries, k: int, filter,
                  tile_rows: int, select_algo: str, res: Resources):
    """The scan at one tile size: each tile's k best by ``select_algo``,
    merged with the running result by a stable sort."""
    n = index.size
    metric = index.metric
    expanded = metric in dist.EXPANDED_METRICS
    select_min = metric not in _MAX_METRICS
    norms = index.norms
    if metric in _NORM_METRICS and norms is None:
        norms = dist.sqnorm(index.dataset)
    qn = dist.sqnorm(queries) if metric in _NORM_METRICS else None
    compute_dtype = res.compute_dtype if expanded else None
    inf = float("inf")
    best_v = best_i = None
    for s in range(0, n, tile_rows):
        tile = index.dataset[s:s + tile_rows]
        d = _tile_distances(queries, qn, tile,
                            None if norms is None else norms[s:s + tile.shape[0]],
                            metric, index.metric_arg, compute_dtype)
        key = d if select_min else -d
        if filter is not None:
            ids = torch.arange(s, s + tile.shape[0], device=res.device)
            key = torch.where(filter.test(ids)[None, :], key, inf)
        kk = min(k, key.shape[1])
        v, i = select_k(key, kk, algo=select_algo)
        i = i.to(torch.int64) + s
        if best_v is not None:
            v, order = torch.sort(torch.cat([best_v, v], 1), dim=1, stable=True)
            i = torch.gather(torch.cat([best_i, i], 1), 1, order)
            v, i = v[:, :k], i[:, :k]
        best_v, best_i = v, i
    best_i = torch.where(best_v == inf, -1, best_i)
    return (best_v if select_min else -best_v), best_i.to(torch.int32)


@traced("brute_force::knn")
def knn(queries, dataset, k: int, metric: str = "sqeuclidean",
        metric_arg: float = 2.0, res: Optional[Resources] = None,
        device: Optional[DeviceLike] = None):
    """One-shot exact k-NN of ``queries`` in ``dataset`` → (distances,
    indices), as :func:`search` over :func:`build`."""
    return search(build(dataset, metric, metric_arg, res=res, device=device),
                  queries, k, res=res, device=device)
