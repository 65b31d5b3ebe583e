"""Sparse nearest neighbours: exact kNN over CSR and the kNN-graph builder
(counterpart of ``raft_tpu/sparse/neighbors.py``). Both go through the
port's :mod:`~raft_tpu_torch.ops.select_k` and
:mod:`~raft_tpu_torch.neighbors.brute_force`."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.ops.select_k import select_k
from raft_tpu_torch.sparse import distance as sp_distance
from raft_tpu_torch.sparse.linalg import symmetrize
from raft_tpu_torch.sparse.types import COO, CSR


def brute_force_knn(index: CSR, queries: CSR, k: int,
                    metric: str = "sqeuclidean",
                    res: Optional[Resources] = None,
                    device: Optional[DeviceLike] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of sparse queries against a sparse index → (dists, ids),
    each (q, k)."""
    res = resources_for(device, res)
    if not 0 < k <= index.shape[0]:
        raise ValueError(f"k={k} out of range for {index.shape[0]} index rows")
    d = sp_distance.pairwise_distance(queries, index, metric, res=res)
    return select_k(d, k)


def knn_graph(dataset, k: int, metric: str = "sqeuclidean",
              res: Optional[Resources] = None,
              device: Optional[DeviceLike] = None) -> COO:
    """Dense rows → symmetric kNN adjacency as COO of capacity 2·n·k.

    Each row contributes its k nearest *other* rows (its self match is
    masked wherever it sits among the k + 1 found), then the directed edges
    are symmetrized with max-dedup, so Borůvka sees an undirected,
    duplicate-free graph."""
    from raft_tpu_torch.neighbors import brute_force

    res = resources_for(device, res)
    dataset = torch.as_tensor(dataset).to(res.device)
    n = dataset.shape[0]
    if not 0 < k < n:
        raise ValueError(f"need 0 < k < n_rows, got k={k}, n={n}")
    bf = brute_force.build(dataset, metric=metric, res=res)
    dists, ids = brute_force.search(bf, dataset, k + 1, res=res)
    rows = torch.arange(n, dtype=torch.int32, device=res.device)
    dists = torch.where(ids == rows[:, None], float("inf"), dists)
    dists, sub = torch.sort(dists, dim=1, stable=True)
    dists = dists[:, :k]
    ids = torch.gather(ids, 1, sub[:, :k])
    src = torch.repeat_interleave(rows, k)
    dst = ids.reshape(-1)
    w = dists.reshape(-1).to(torch.float32)
    valid = dst >= 0
    directed = COO(torch.where(valid, src, -1), torch.where(valid, dst, 0),
                   torch.where(valid, w, 0.0), (n, n))
    return symmetrize(directed, mode="max")
