"""Exact kNN past one score matrix: the device-chunked scan, the out-of-core
host-streamed scan and the lazy batch-k query iterator (counterpart of
``raft_tpu/neighbors/batch_knn.py``).

* :func:`search_device_chunked` — the dataset is on the card, but its
  (q, n) score block is not: a loop over (chunk_rows, dim) windows, each
  one full-fp32 product (``ops.distance.matmul_t``; TF32 is off) and an
  exact top-k (ascending, lowest row on ties) merged into the running
  (q, k) result. The last window is clamped to end at row n, as the JAX
  package's ``dynamic_slice`` clamps it, and its re-scanned rows are
  masked. An OOM-classified failure runs the scan again at half the chunk,
  down to a floor (``resilience.degrade_on_oom``).
* :func:`search_out_of_core` — the dataset stays in host memory (numpy,
  ``np.memmap``); row chunks go to the card by
  ``torch.from_numpy(...).to(device)``, one at a time (no copy overlaps a
  product here), with the deadline, interrupt and faultpoint hooks of the
  JAX package between chunks.
* :class:`BatchKQuery` — neighbours in slabs of ``batch_size`` ranks, each
  pull one brute-force search at the larger k.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.ops import distance as dist_mod
from raft_tpu_torch.ops.select_k import iter_topk_min, select_k

SUPPORTED_METRICS = ("sqeuclidean", "euclidean", "inner_product", "cosine")


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                           min=1e-30)


def _chunk_topk(queries, qn, chunk, chunk_norms, row0: int, k: int,
                metric: str, select_algo: str):
    """Exact top-k of one chunk on the card, ids offset by ``row0``."""
    ip = dist_mod.matmul_t(queries, chunk)
    if metric in ("sqeuclidean", "euclidean"):
        d = torch.clamp(qn[:, None] + chunk_norms[None, :] - 2.0 * ip, min=0.0)
    elif metric == "cosine":
        d = 1.0 - ip  # operands pre-normalized
    else:
        d = -ip  # inner_product ranked by max
    vals, ids = select_k(d, min(k, chunk.shape[0]), algo=select_algo)
    return vals, ids + row0


def _merge_running(best_v, best_i, vals, ids, k: int):
    """The k smallest of the running result and a chunk's, stable (the
    running result wins ties, then the lower column)."""
    allv = torch.cat([best_v, vals], dim=1)
    alli = torch.cat([best_i, ids.to(best_i.dtype)], dim=1)
    v, sel = torch.sort(allv, dim=1, stable=True)
    return v[:, :k], torch.gather(alli, 1, sel[:, :k])


def _device_chunked_scan(dataset, queries, k: int, chunk_rows: int,
                         metric: str):
    """The chunked scan at one chunk size."""
    n, _ = dataset.shape
    q = queries.shape[0]
    chunk_rows = min(chunk_rows, n)
    queries = queries.to(torch.float32)
    if metric == "cosine":
        queries = _normalize(queries)
    qn = dist_mod.sqnorm(queries)
    n_chunks = -(-n // chunk_rows)
    inf = float("inf")
    dev = queries.device
    best_v = torch.full((q, k), inf, dtype=torch.float32, device=dev)
    best_i = torch.full((q, k), -1, dtype=torch.int32, device=dev)
    for c in range(n_chunks):
        # the tail window ends at row n, as a clamped dynamic_slice does;
        # its re-scanned rows are masked so no id enters twice
        start = min(c * chunk_rows, max(n - chunk_rows, 0))
        chunk = dataset[start:start + chunk_rows].to(torch.float32)
        rows = torch.arange(start, start + chunk_rows, dtype=torch.int32,
                            device=dev)
        if metric == "cosine":
            chunk = _normalize(chunk)
        ip = dist_mod.matmul_t(queries, chunk)
        if metric == "inner_product":
            d = -ip
        elif metric == "cosine":
            d = 1.0 - ip
        else:
            d = torch.clamp(qn[:, None] + dist_mod.sqnorm(chunk)[None, :]
                            - 2.0 * ip, min=0.0)
        d = torch.where((rows >= c * chunk_rows)[None, :], d, inf)
        vals, sel = iter_topk_min(d, k)
        ids = torch.where(torch.isinf(vals), -1, rows[sel.long()])
        best_v, best_i = _merge_running(best_v, best_i, vals, ids, k)
    if metric == "inner_product":
        best_v = torch.where(best_i >= 0, -best_v, -inf)
    elif metric == "euclidean":
        best_v = torch.where(best_i >= 0, torch.sqrt(best_v), inf)
    return best_v, best_i


@traced("batch_knn::search_device_chunked")
def search_device_chunked(dataset, queries, k: int, chunk_rows: int = 131072,
                          metric: str = "sqeuclidean",
                          res: Optional[Resources] = None,
                          device: Optional[DeviceLike] = None):
    """Exact kNN over a dataset on the card whose (q, n) score block does
    not fit → (distances (q, k), indices (q, k) int32). ``chunk_rows``
    sizes the resident (chunk + (q, chunk) scores) workspace; an
    OOM-classified failure re-runs at half the chunk down to
    max(k, 128) rows, counting ``resilience.degraded_tile``."""
    from raft_tpu_torch.resilience import degrade_on_oom, faultpoint

    res = resources_for(device, res)
    metric = dist_mod.canonical_metric(metric)
    if metric not in SUPPORTED_METRICS:
        raise ValueError(
            f"supported metrics {SUPPORTED_METRICS}, got {metric!r}")
    dataset = torch.as_tensor(dataset).to(res.device)
    queries = torch.as_tensor(queries).to(device=res.device,
                                          dtype=torch.float32)
    chunk_rows = min(int(chunk_rows), dataset.shape[0])

    def attempt(rows):
        faultpoint("batch_knn.search_device_chunked")
        return _device_chunked_scan(dataset, queries, int(k), int(rows),
                                    metric)

    floor = min(chunk_rows, max(int(k), 128))
    return degrade_on_oom(attempt, chunk_rows, floor=floor,
                          site="batch_knn.search_device_chunked")


@traced("batch_knn::search_out_of_core")
def search_out_of_core(dataset, queries, k: int, metric: str = "sqeuclidean",
                       chunk_rows: int = 0, select_algo: str = "exact",
                       res: Optional[Resources] = None,
                       device: Optional[DeviceLike] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN over a host-resident (n, dim) dataset (numpy-like,
    ``np.memmap`` works) streamed to the card in row chunks; the dataset is
    never whole on the card → (distances (q, k), indices (q, k) int32).
    ``chunk_rows`` 0 sizes a chunk and its (q, chunk) block by
    ``res.workspace_bytes``."""
    res = resources_for(device, res)
    metric = dist_mod.canonical_metric(metric)
    if metric not in SUPPORTED_METRICS:
        raise ValueError(
            f"supported metrics {SUPPORTED_METRICS}, got {metric!r}")
    n, dim = dataset.shape
    queries = torch.as_tensor(queries).to(device=res.device,
                                          dtype=torch.float32)
    if queries.ndim != 2 or queries.shape[1] != dim:
        raise ValueError(
            f"queries must be (q, {dim}), got {tuple(queries.shape)}")
    if not 0 < k <= n:
        raise ValueError(f"k={k} out of range for {n} rows")
    if metric == "cosine":
        queries = _normalize(queries)
    if chunk_rows <= 0:
        q = queries.shape[0]
        chunk_rows = int(max(k, min(n, res.workspace_bytes
                                    // max(1, (dim + q) * 4))))
    qn = dist_mod.sqnorm(queries)

    from raft_tpu_torch.core.interruptible import check_interrupt
    from raft_tpu_torch.resilience import (active_deadline, degrade_on_oom,
                                           faultpoint)

    def scan(chunk_rows):
        # the whole host loop is the degradation unit: an OOM restarts the
        # scan at half the chunk; an expired Deadline stops after at least
        # one chunk and marks the scope degraded (the running top-k over
        # the scanned prefix is the partial result)
        q = queries.shape[0]
        best_v = torch.full((q, k), float("inf"), dtype=torch.float32,
                            device=res.device)
        best_i = torch.full((q, k), -1, dtype=torch.int32, device=res.device)
        for s in range(0, n, chunk_rows):
            dl = active_deadline()
            if dl is not None and s > 0 and dl.reached():
                dl.mark_degraded("batch_knn.search_out_of_core")
                break
            check_interrupt()
            faultpoint("batch_knn.search_out_of_core.chunk")
            host_chunk = np.ascontiguousarray(np.asarray(
                dataset[s:s + chunk_rows], dtype=np.float32))
            chunk = torch.from_numpy(host_chunk).to(res.device)
            if metric == "cosine":
                chunk = _normalize(chunk)
            cn = dist_mod.sqnorm(chunk)
            vals, ids = _chunk_topk(queries, qn, chunk, cn, s, int(k), metric,
                                    select_algo)
            if vals.shape[1] < k:  # short final chunk: pad before the merge
                pad = k - vals.shape[1]
                vals = torch.nn.functional.pad(vals, (0, pad),
                                               value=float("inf"))
                ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
            best_v, best_i = _merge_running(best_v, best_i, vals, ids, int(k))
        return best_v, best_i

    best_v, best_i = degrade_on_oom(
        scan, chunk_rows, floor=min(int(chunk_rows), max(int(k), 128)),
        site="batch_knn.search_out_of_core")

    if metric == "euclidean":
        best_v = torch.sqrt(torch.clamp(best_v, min=0.0))
    elif metric == "inner_product":
        best_v = torch.where(best_i >= 0, -best_v, -float("inf"))
        return best_v, best_i
    best_v = torch.where(best_i >= 0, best_v, float("inf"))
    return best_v, best_i


class BatchKQuery:
    """Lazy neighbour-slab iterator: yields ``(distances (q, b), indices
    (q, b))`` for ranks [0, b), then [b, 2b), … up to the index size, each
    pull one :func:`~raft_tpu_torch.neighbors.brute_force.search` at the
    larger k (the reference re-selects per batch the same way)."""

    def __init__(self, index, queries, batch_size: int,
                 res: Optional[Resources] = None,
                 device: Optional[DeviceLike] = None):
        from raft_tpu_torch.neighbors import brute_force

        self._bf = brute_force
        self.index = index
        self.res = resources_for(device, res)
        self.queries = torch.as_tensor(queries).to(self.res.device)
        self.batch_size = int(batch_size)
        if self.batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self._cached_k = 0
        self._vals = None
        self._ids = None

    def _ensure(self, upto: int) -> None:
        upto = min(upto, self.index.size)
        if upto <= self._cached_k:
            return
        self._vals, self._ids = self._bf.search(self.index, self.queries,
                                                upto, res=self.res)
        self._cached_k = upto

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        offset = 0
        n = self.index.size
        while offset < n:
            b = min(self.batch_size, n - offset)
            self._ensure(offset + b)
            yield (self._vals[:, offset:offset + b],
                   self._ids[:, offset:offset + b])
            offset += b
