"""Exact k-NN by brute force (counterpart of
``raft_tpu/neighbors/brute_force.py``), sqeuclidean only in this slice.

The search is tiled over the dataset — 10k queries against 1M rows would be
40 GB of fp32 distances — with a running top-k merge: each tile's distances
come from one ``torch.matmul`` (full fp32, TF32 off), its k best by a
stable sort, and a stable merge with the running result, so ties go to the
lowest row id as in the JAX package. This is the ground truth of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.ops.distance import canonical_metric, matmul_t, sqnorm

SUPPORTED_METRICS = ("sqeuclidean",)


@dataclass
class BruteForceIndex:
    dataset: torch.Tensor          # (n, dim), any real dtype
    norms: torch.Tensor            # (n,) fp32 squared norms
    metric: str = "sqeuclidean"

    @property
    def size(self) -> int:
        return self.dataset.shape[0]

    @property
    def dim(self) -> int:
        return self.dataset.shape[1]


def build(dataset, metric: str = "sqeuclidean",
          res: Optional[Resources] = None,
          device: Optional[DeviceLike] = None) -> BruteForceIndex:
    """Keep the dataset on the device with its row norms."""
    metric = canonical_metric(metric)
    if metric not in SUPPORTED_METRICS:
        raise NotImplementedError(
            f"brute_force metric {metric!r} arrives with a later slice of the "
            f"port; this one has {SUPPORTED_METRICS}")
    res = resources_for(device, res)
    data = torch.as_tensor(dataset).to(res.device)
    return BruteForceIndex(data, sqnorm(data), metric)


def search(index: BruteForceIndex, queries, k: int,
           tile_rows: Optional[int] = None,
           res: Optional[Resources] = None,
           device: Optional[DeviceLike] = None):
    """Exact k-NN → (distances (q, k) fp32, indices (q, k) int32)."""
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
    if tile_rows is None:
        # the (q, tile) distance block, its sorted copy and int64 order
        per_col = max(1, q * 16 + index.dim * 4)
        tile_rows = int(min(n, max(k, res.workspace_bytes // per_col)))
    tile_rows = max(min(int(tile_rows), n), k)
    qn = sqnorm(queries)
    best_v = best_i = None
    for s in range(0, n, tile_rows):
        tile = index.dataset[s:s + tile_rows]
        d = torch.clamp(qn[:, None] + index.norms[None, s:s + tile.shape[0]]
                        - 2.0 * matmul_t(queries, tile), min=0.0)
        kk = min(k, d.shape[1])
        v, i = torch.sort(d, dim=1, stable=True)
        v, i = v[:, :kk], i[:, :kk] + s
        if best_v is not None:
            v, order = torch.sort(torch.cat([best_v, v], 1), dim=1, stable=True)
            i = torch.gather(torch.cat([best_i, i], 1), 1, order)
            v, i = v[:, :k], i[:, :k]
        best_v, best_i = v, i
    return best_v, best_i.to(torch.int32)


def knn(queries, dataset, k: int, metric: str = "sqeuclidean",
        res: Optional[Resources] = None,
        device: Optional[DeviceLike] = None):
    """One-shot exact k-NN of ``queries`` in ``dataset`` → (distances,
    indices), as :func:`search` over :func:`build`."""
    return search(build(dataset, metric, res=res, device=device), queries, k,
                  res=res, device=device)
