"""Spectral partition (counterpart of ``raft_tpu/spectral/partition.py``):
the Laplacian's smallest eigenvectors by Lanczos, then k-means on the
row-normalised embedding; analysis by edge cut and cost.

Both random draws (Lanczos start vectors, k-means++ seeding) come from
``torch.Generator``s seeded from ``seed``, not ``jax.random``'s streams, so
a partition agrees with the JAX package's as a partition (up to labels),
not bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.cluster import kmeans
from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.sparse.convert import coo_to_csr
from raft_tpu_torch.sparse.linalg import _segment_sum, laplacian
from raft_tpu_torch.sparse.solver import lanczos_smallest
from raft_tpu_torch.sparse.types import COO


def fit_embedding(graph: COO, n_components: int, normalized: bool = True,
                  max_iters: int = 0, seed: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-eigenpair Laplacian embedding → (eigenvalues (k,),
    vectors (n, k)), on the graph's device."""
    n = graph.shape[0]
    if not 0 < n_components < n:
        raise ValueError(f"need 0 < n_components < {n}")
    lap = coo_to_csr(laplacian(graph, normalized=normalized))
    return lanczos_smallest(lap, n_components, max_iters=max_iters, seed=seed)


def partition(graph: COO, n_clusters: int, n_eigenvecs: int = 0,
              normalized: bool = True, seed: int = 0,
              res: Optional[Resources] = None,
              device: Optional[DeviceLike] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spectral graph partition → (labels (n,), eigenvalues,
    eigenvectors); ``n_eigenvecs`` defaults to ``n_clusters``."""
    res = resources_for(device, res)
    if graph.device != res.device:
        raise ValueError(f"graph lives on {graph.device}, the partition "
                         f"runs on {res.device}")
    k = int(n_eigenvecs) or int(n_clusters)
    evals, evecs = fit_embedding(graph, k, normalized=normalized, seed=seed)
    emb = evecs / torch.clamp(torch.linalg.vector_norm(evecs, dim=1,
                                                       keepdim=True),
                              min=1e-12)
    labels, _ = kmeans.fit_predict(
        emb, kmeans.KMeansParams(n_clusters=int(n_clusters), seed=seed),
        res=res)
    return labels, evals, evecs


def analyze_partition(graph: COO, labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """(edge_cut_weight, cost) of a partition: cost = Σ_i (weight of edges
    cut by part i) / |part i|."""
    labels = torch.as_tensor(labels, device=graph.device).to(torch.int64)
    n = graph.shape[0]
    lu = labels[torch.clamp(graph.rows, 0, n - 1).long()]
    lv = labels[torch.clamp(graph.cols, 0, n - 1).long()]
    cut_e = graph.valid & (lu != lv)
    cut_w = torch.where(cut_e, graph.vals, torch.zeros_like(graph.vals))
    # both directions present → each undirected cut edge counted twice
    edge_cut = cut_w.sum() / 2.0
    k = labels.shape[0]
    part_sizes = torch.bincount(labels, minlength=k)[:k]
    cut_per_part = _segment_sum(cut_w, torch.clamp(lu, 0, k - 1), k)
    cost = torch.where(part_sizes > 0,
                       cut_per_part / torch.clamp(part_sizes, min=1),
                       0.0).sum()
    return edge_cut, cost
