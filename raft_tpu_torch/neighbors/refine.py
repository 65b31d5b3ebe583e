"""Exact re-ranking of ANN candidates (counterpart of
``raft_tpu/neighbors/refine.py``): gather each query's candidate rows,
score them exactly with one batched product, keep the best k. Tiled over
queries by the workspace budget; candidate id -1 is skipped and never
dereferenced. :func:`refine_host` is the same contract in numpy, for a
CPU serving pipeline (the re-rank beside the hnsw export)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.ops.distance import canonical_metric, sqnorm
from raft_tpu_torch.ops.select_k import select_k

SUPPORTED_METRICS = ("sqeuclidean", "euclidean", "inner_product", "cosine")


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                           min=1e-30)


@traced("refine::refine")
def refine(dataset, queries, candidates, k: int, metric: str = "sqeuclidean",
           res: Optional[Resources] = None,
           device: Optional[DeviceLike] = None):
    """Re-rank ``candidates`` (q, n_cand) by exact distance → top-k
    (distances fp32, ids int32), with -1 / +inf (-inf for inner product)
    where fewer than k candidates are valid. An integer dataset stays in
    its storage dtype; only the gathered rows are widened."""
    res = resources_for(device, res)
    metric = canonical_metric(metric)
    if metric not in SUPPORTED_METRICS:
        raise ValueError(f"refine supports {SUPPORTED_METRICS}, got {metric!r}")
    dev = res.device
    dataset = torch.as_tensor(dataset).to(dev)
    if dataset.is_floating_point():
        dataset = dataset.to(torch.float32)
    queries = torch.as_tensor(queries).to(device=dev, dtype=torch.float32)
    candidates = torch.as_tensor(candidates).to(device=dev, dtype=torch.int64)
    if queries.shape[1] != dataset.shape[1]:
        raise ValueError(f"dim mismatch: {queries.shape[1]} != {dataset.shape[1]}")
    if candidates.shape[0] != queries.shape[0]:
        raise ValueError("candidates must have one row per query")
    if not 0 < k <= candidates.shape[1]:
        raise ValueError(f"k={k} out of range for n_candidates={candidates.shape[1]}")
    l2 = metric in ("sqeuclidean", "euclidean")
    if metric == "cosine":
        queries = _normalize(queries)
        dataset = _normalize(dataset.to(torch.float32))
    per_query = max(1, candidates.shape[1] * (dataset.shape[1] + 4) * 4)
    q_tile = int(max(1, min(queries.shape[0], res.workspace_bytes // per_query)))
    out_v, out_i = [], []
    for s in range(0, queries.shape[0], q_tile):
        qb = queries[s:s + q_tile]
        cb = candidates[s:s + q_tile]
        vecs = dataset[cb.clamp(min=0)].to(torch.float32)   # (qt, c, dim)
        ip = torch.einsum("qd,qcd->qc", qb, vecs)
        if l2:
            d = torch.clamp(sqnorm(qb)[:, None] + sqnorm(vecs, dim=2) - 2.0 * ip,
                            min=0.0)
            if metric == "euclidean":
                d = torch.sqrt(d)
        elif metric == "cosine":
            d = 1.0 - ip
        else:
            d = -ip
        d = torch.where(cb >= 0, d, torch.full_like(d, float("inf")))
        vals, sel = select_k(d, k, select_min=True)
        ids = torch.gather(cb, 1, sel.to(torch.int64))
        ids = torch.where(torch.isinf(vals), torch.full_like(ids, -1), ids)
        if metric == "inner_product":
            vals = -vals
        out_v.append(vals)
        out_i.append(ids.to(torch.int32))
    return torch.cat(out_v), torch.cat(out_i)


def refine_host(dataset, queries, candidates, k: int,
                metric: str = "sqeuclidean") -> Tuple[np.ndarray, np.ndarray]:
    """Exact re-rank in numpy (the reference's refine_host,
    detail/refine_host-inl.hpp): :func:`refine`'s contract on host arrays,
    touching no device → (distances (q, k) fp32, ids (q, k) int32)."""
    metric = canonical_metric(metric)
    if metric not in SUPPORTED_METRICS:
        raise ValueError(
            f"refine_host supports {SUPPORTED_METRICS}, got {metric!r}")
    dataset = np.asarray(dataset, np.float32)
    queries = np.asarray(queries, np.float32)
    cand = np.asarray(candidates, np.int64)
    if not 0 < k <= cand.shape[1]:
        raise ValueError(f"k={k} out of range for n_candidates={cand.shape[1]}")
    if metric == "cosine":
        queries = queries / np.maximum(
            np.linalg.norm(queries, axis=1, keepdims=True), 1e-30)
        dataset = dataset / np.maximum(
            np.linalg.norm(dataset, axis=1, keepdims=True), 1e-30)
    rows = dataset[np.clip(cand, 0, dataset.shape[0] - 1)]      # (q, c, d)
    ip = np.einsum("qd,qcd->qc", queries, rows)
    if metric in ("sqeuclidean", "euclidean"):
        d = np.maximum(np.sum(queries ** 2, 1)[:, None]
                       + np.sum(rows ** 2, 2) - 2.0 * ip, 0.0)
        if metric == "euclidean":
            d = np.sqrt(d)
    elif metric == "cosine":
        d = 1.0 - ip
    else:          # inner product ranks by max: negate for the min-select
        d = -ip
    d = np.where(cand >= 0, d, np.inf)
    sel = np.argsort(d, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(d, sel, axis=1)
    ids = np.take_along_axis(cand, sel, axis=1).astype(np.int32)
    ids = np.where(np.isfinite(vals), ids, -1)
    if metric == "inner_product":
        vals = np.where(ids >= 0, -vals, -np.inf)
    else:
        vals = np.where(ids >= 0, vals, np.inf)
    return vals.astype(np.float32), ids
