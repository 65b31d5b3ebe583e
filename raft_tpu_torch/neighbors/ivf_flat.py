"""IVF-Flat helpers the IVF-PQ strip path shares (counterpart of the
matching functions in ``raft_tpu/neighbors/ivf_flat.py``). IVF-Flat's own
index, build and search arrive with the next slice of the port."""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.ops import strip_scan as ss
from raft_tpu_torch.ops.distance import sqnorm


def _lens_np(index) -> np.ndarray:
    """Per-list entry counts on the host, cached on the index: planning
    needs them every search and a refetch would sync the device."""
    cached = getattr(index, "_lens_np_cache", None)
    if cached is None or cached.shape[0] != index.n_lists:
        cached = index.list_sizes().cpu().numpy()
        index._lens_np_cache = cached
    return cached


def _finalize_ragged(vals: torch.Tensor, ids: torch.Tensor,
                     queries: torch.Tensor, metric: str):
    """Strip-scan scores → distances: add ‖q‖² back for L2 (clamped at 0,
    square-rooted for euclidean), ``1 + v`` for cosine, ``-v`` for inner
    product; ±inf where the id is -1."""
    inf = torch.full_like(vals, float("inf"))
    if metric in ("sqeuclidean", "euclidean"):
        vals = torch.clamp(vals + sqnorm(queries)[:, None], min=0.0)
        if metric == "euclidean":
            vals = torch.sqrt(vals)
        return torch.where(ids >= 0, vals, inf), ids
    if metric == "cosine":
        return torch.where(ids >= 0, 1.0 + vals, inf), ids
    return torch.where(ids >= 0, -vals, -inf), ids


def _ragged_plan_static(index, n_probes: int, k: int, res, dim: int):
    """Length classes, per-class list counts, the device class ordinals
    (cached on the index: they depend only on list lengths) and the query
    tile for this search."""
    cached = getattr(index, "_ragged_static_cache", None)
    if cached is None:
        classes, cls_ord_np = ss.class_info(_lens_np(index), dim=dim)
        classes = tuple(classes)
        cached = (classes, ss.class_counts_of(cls_ord_np, len(classes)),
                  torch.as_tensor(cls_ord_np, device=index.centers.device))
        index._ragged_static_cache = cached
    classes, class_counts, cls_ord = cached
    q_tile = ss.fit_q_tile(1 << 30, n_probes, index.n_lists, len(classes),
                           int(k), res.workspace_bytes, dim=dim,
                           class_counts=class_counts)
    return classes, class_counts, cls_ord, q_tile
