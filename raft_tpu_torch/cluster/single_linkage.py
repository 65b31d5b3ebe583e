"""Single-linkage agglomerative clustering (counterpart of
``raft_tpu/cluster/single_linkage.py``).

The JAX package's pipeline: a connectivity graph (all pairs, or kNN with
k = log2(n) + c) → Borůvka MST (``sparse/solver.py``) → in kNN mode, while
the MST is a forest, add each component's minimum cross-component edge
and run the MST again (at most 32 rounds, then ``RuntimeError``) → cut the
heaviest edges so exactly ``n_clusters`` components remain and label them
monotonically. The cross-component search runs in row tiles sized by the
workspace (one (tile, n) distance block at a time, where the JAX package
forms the whole (n, n) block); each row's nearest foreign point is the
same either way, lowest index on ties.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core.interruptible import check_interrupt
from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.label import make_monotonic
from raft_tpu_torch.ops import distance as dist_mod
from raft_tpu_torch.sparse.solver import (MstResult, _segment_min,
                                          connected_components, mst)
from raft_tpu_torch.sparse.types import COO


@dataclass
class LinkageResult:
    """Flat labels and the MST's merge edges sorted by height."""

    labels: torch.Tensor       # (n,) int32 in [0, n_clusters)
    mst_src: torch.Tensor      # (n-1,) merge edges, sorted by height
    mst_dst: torch.Tensor
    mst_heights: torch.Tensor  # (n-1,) float32
    n_clusters: int

    def to_scipy_linkage(self) -> np.ndarray:
        """The scipy-style (n-1, 4) linkage matrix Z, by a host union-find
        walk over the sorted merge edges."""
        src = self.mst_src.cpu().numpy()
        dst = self.mst_dst.cpu().numpy()
        h = self.mst_heights.cpu().numpy()
        if (src < 0).any() or (dst < 0).any() or not np.isfinite(h).all():
            raise ValueError(
                "spanning tree is a forest (disconnected data); "
                "no dendrogram exists"
            )
        n = src.shape[0] + 1
        parent = list(range(2 * n - 1))
        size = [1] * (2 * n - 1)

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        Z = np.zeros((n - 1, 4))
        for i in range(n - 1):
            ra, rb = find(int(src[i])), find(int(dst[i]))
            new = n + i
            parent[ra] = new
            parent[rb] = new
            size[new] = size[ra] + size[rb]
            Z[i] = (min(ra, rb), max(ra, rb), h[i], size[new])
        return Z


def _full_graph(X: torch.Tensor, metric: str, res: Resources) -> COO:
    """All-pairs connectivity, self-pairs as padding."""
    n = X.shape[0]
    d = dist_mod.pairwise_distance(X, X, metric, res=res)
    ar = torch.arange(n, dtype=torch.int32, device=X.device)
    rows = ar.repeat_interleave(n)
    cols = ar.repeat(n)
    off_diag = rows != cols
    return COO(torch.where(off_diag, rows, -1), torch.where(off_diag, cols, 0),
               torch.where(off_diag, d.reshape(-1), 0.0), (n, n))


def _cross_component_edges(X: torch.Tensor, color: torch.Tensor, metric: str,
                           res: Resources) -> COO:
    """Each component's minimum edge to any other component (both
    directions): every point's nearest foreign point, then each component's
    best point, lowest index on ties."""
    n = X.shape[0]
    tile = int(max(1, min(n, res.workspace_bytes // max(1, n * 4 * 3))))
    best, w = [], []
    for s in range(0, n, tile):
        d = dist_mod.pairwise_distance(X[s:s + tile], X, metric, res=res)
        d = torch.where(color[s:s + tile, None] == color[None, :],
                        float("inf"), d)
        v, i = torch.min(d, dim=1)
        w.append(v)
        best.append(i.to(torch.int32))
    pt_best = torch.cat(best)
    pt_w = torch.cat(w)
    cl = color.long()
    comp_w = _segment_min(pt_w, cl, n, float("inf"))
    at_min = pt_w == comp_w[cl]
    ar = torch.arange(n, dtype=torch.int32, device=X.device)
    src = _segment_min(torch.where(at_min, ar, n), cl, n,
                       torch.iinfo(torch.int32).max)
    has = src < n
    srcc = torch.clamp(src, 0, n - 1)
    dst = pt_best[srcc.long()]
    wt = pt_w[srcc.long()]
    rows = torch.cat([torch.where(has, srcc, -1), torch.where(has, dst, -1)])
    cols = torch.cat([torch.where(has, dst, 0), torch.where(has, srcc, 0)])
    vals = torch.cat([torch.where(has, wt, 0.0)] * 2).to(torch.float32)
    return COO(rows, cols, vals, (n, n))


def single_linkage(X, n_clusters: int, metric: str = "sqeuclidean",
                   connectivity: str = "knn", c: int = 15,
                   res: Optional[Resources] = None,
                   device: Optional[DeviceLike] = None) -> LinkageResult:
    """Fit single-linkage clustering and cut at ``n_clusters``; ``c`` sets
    k = log2(n) + c for the kNN connectivity."""
    res = resources_for(device, res)
    X = torch.as_tensor(X).to(device=res.device, dtype=torch.float32)
    if X.ndim != 2:
        raise ValueError(f"X must be 2-D, got {tuple(X.shape)}")
    n = X.shape[0]
    if not 0 < n_clusters <= n:
        raise ValueError(f"need 0 < n_clusters <= {n}, got {n_clusters}")
    if connectivity not in ("knn", "pairwise"):
        raise ValueError(
            f"connectivity must be 'knn'|'pairwise', got {connectivity!r}")

    if connectivity == "pairwise":
        result = mst(_full_graph(X, metric, res))
    else:
        from raft_tpu_torch.sparse.neighbors import knn_graph

        k = min(n - 1, int(math.log2(n)) + c)
        graph = knn_graph(X, k, metric=metric, res=res)
        result = mst(graph)
        # repair rounds: forest → add min cross-component edges, redo MST
        for _ in range(32):
            check_interrupt()
            if int(result.n_edges) == n - 1:
                break
            extra = _cross_component_edges(X, result.color, metric, res)
            graph = COO(torch.cat([graph.rows, extra.rows]),
                        torch.cat([graph.cols, extra.cols]),
                        torch.cat([graph.vals, extra.vals]), (n, n))
            result = mst(graph)
        if int(result.n_edges) != n - 1:
            raise RuntimeError(
                f"connectivity repair left {n - int(result.n_edges)} "
                "components (non-finite distances?); use "
                "connectivity='pairwise' or a larger c"
            )
    return _cut(result, n, int(n_clusters))


def _cut(result: MstResult, n: int, n_clusters: int) -> LinkageResult:
    """Sort merge edges by height, drop the heaviest so exactly
    ``n_clusters`` components remain, label the rest."""
    dev = result.src.device
    slots = torch.arange(result.src.shape[0], device=dev)
    order = torch.argsort(torch.where(slots < result.n_edges, result.weight,
                                      float("inf")), stable=True)
    src = result.src[order]
    dst = result.dst[order]
    h = result.weight[order]
    n_comp = n - result.n_edges
    n_drop = torch.clamp(n_clusters - n_comp, min=0)
    keep = slots < (result.n_edges - n_drop)
    rows = torch.cat([torch.where(keep, src, -1), torch.where(keep, dst, -1)])
    cols = torch.cat([torch.where(keep, dst, 0), torch.where(keep, src, 0)])
    vals = torch.cat([torch.where(keep, h, 0.0)] * 2)
    color = connected_components(COO(rows, cols, vals, (n, n)))
    labels, _ = make_monotonic(color)
    return LinkageResult(labels, src, dst, h, n_clusters)
