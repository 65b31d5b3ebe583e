"""Distance primitives (counterpart of ``raft_tpu/ops/distance.py``):
squared norms, ``x @ y.T`` with fp32 accumulation, the tiled
nearest-center argmin that k-means assigns with, and
:func:`pairwise_distance` over every metric of :data:`ALL_METRICS`.

Two regimes, as in the JAX package: the expanded metrics are one gemm plus
row statistics; the elementwise ones reduce a broadcast (rows, n, dim)
block, row-tiled so it stays inside the workspace. fp32 products are full
fp32: TF32 is off (``core/resources.py``), which is the port's form of the
reference's ``precision="highest"``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for

_ALIASES = {
    "l2": "sqeuclidean", "l2_expanded": "sqeuclidean",
    "l2_unexpanded": "sqeuclidean", "euclidean_expanded": "euclidean",
    "l2sqrt": "euclidean", "l2sqrtexpanded": "euclidean",
    "cityblock": "l1", "manhattan": "l1", "taxicab": "l1",
    "linf": "chebyshev", "lp": "minkowski",
    "ip": "inner_product", "dot": "inner_product",
    "kl": "kl_divergence", "kldivergence": "kl_divergence",
    "jensen-shannon": "jensenshannon",
}

EXPANDED_METRICS = frozenset({
    "sqeuclidean", "euclidean", "cosine", "inner_product", "correlation",
    "hellinger", "jaccard", "dice", "russellrao"})
ELEMENTWISE_METRICS = frozenset({
    "l1", "chebyshev", "minkowski", "canberra", "braycurtis", "hamming",
    "jensenshannon", "kl_divergence"})
ALL_METRICS = EXPANDED_METRICS | ELEMENTWISE_METRICS | {"haversine"}


def canonical_metric(metric: str) -> str:
    """The canonical name of a metric or alias; ``ValueError`` if unknown."""
    m = metric.lower()
    m = _ALIASES.get(m, m)
    if m not in ALL_METRICS:
        raise ValueError(f"unknown metric {metric!r}; supported: "
                         f"{sorted(ALL_METRICS)}")
    return m


def sqnorm(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Row squared-L2 norms, squaring in fp32."""
    xf = x.to(torch.float32)
    return torch.sum(xf * xf, dim=dim)


def matmul_t(x: torch.Tensor, y: torch.Tensor,
             compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ y.T`` → fp32. With ``compute_dtype=torch.bfloat16`` the inputs
    are rounded to bf16 first; their products are exact in fp32, so the
    result is the bf16-in / fp32-accumulate product the reference computes
    (on the CPU a bf16 matmul would return bf16, hence the upcast)."""
    if compute_dtype is not None and compute_dtype != torch.float32:
        x = x.to(compute_dtype)
        y = y.to(compute_dtype)
    return x.to(torch.float32) @ y.to(torch.float32).T


def expanded_sqeuclidean(x: torch.Tensor, y: torch.Tensor,
                         compute_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """All-pairs squared L2 via one gemm, clamped at 0."""
    ip = matmul_t(x, y, compute_dtype)
    return torch.clamp(sqnorm(x)[:, None] + sqnorm(y)[None, :] - 2.0 * ip,
                       min=0.0)


def fused_l2_nn_argmin(x: torch.Tensor, y: torch.Tensor, sqrt: bool = False,
                       workspace_bytes: int = 1 << 30
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row nearest row of ``y`` under L2: (min d², int64 argmin), or the
    distance itself with ``sqrt``; tiled over ``x`` so that no (tile, n_y)
    fp32 block exceeds the workspace. Ties go to the lowest index, as
    ``jnp.argmin``. A plain gemm plus a row argmin: the JAX package computes
    it outside any Pallas kernel too."""
    m = x.shape[0]
    n = y.shape[0]
    tm = max(1, min(int(workspace_bytes) // max(1, n * 4 * 4), 8192))
    yn = sqnorm(y)
    vals, idxs = [], []
    for s in range(0, m, tm):
        xt = x[s:s + tm]
        d2 = torch.clamp(sqnorm(xt)[:, None] + yn[None, :]
                         - 2.0 * matmul_t(xt, y), min=0.0)
        v, i = torch.min(d2, dim=1)
        vals.append(torch.sqrt(v) if sqrt else v)
        idxs.append(i)
    return torch.cat(vals), torch.cat(idxs)


def _expanded_distance(x: torch.Tensor, y: torch.Tensor, metric: str,
                       compute_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """A gemm-based metric: ``x @ y.T`` and row statistics → (m, n)."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    if metric == "correlation":
        return _expanded_distance(x - x.mean(dim=1, keepdim=True),
                                  y - y.mean(dim=1, keepdim=True), "cosine",
                                  compute_dtype)
    if metric == "hellinger":
        sq_ip = matmul_t(torch.sqrt(torch.clamp(x, min=0.0)),
                         torch.sqrt(torch.clamp(y, min=0.0)), compute_dtype)
        return torch.sqrt(torch.clamp(1.0 - sq_ip, min=0.0))
    ip = matmul_t(x, y, compute_dtype)
    if metric == "inner_product":
        return ip
    if metric in ("sqeuclidean", "euclidean"):
        d2 = torch.clamp(sqnorm(x)[:, None] + sqnorm(y)[None, :] - 2.0 * ip,
                         min=0.0)
        return torch.sqrt(d2) if metric == "euclidean" else d2
    if metric == "cosine":
        denom = torch.clamp(torch.sqrt(sqnorm(x))[:, None]
                            * torch.sqrt(sqnorm(y))[None, :], min=1e-30)
        return 1.0 - ip / denom
    if metric == "jaccard":       # generalised (Tanimoto)
        denom = sqnorm(x)[:, None] + sqnorm(y)[None, :] - ip
        return 1.0 - torch.where(denom > 0,
                                 ip / torch.clamp(denom, min=1e-30), 1.0)
    if metric == "dice":
        denom = x.sum(dim=1)[:, None] + y.sum(dim=1)[None, :]
        return 1.0 - torch.where(denom > 0,
                                 2.0 * ip / torch.clamp(denom, min=1e-30),
                                 1.0)
    if metric == "russellrao":
        k = x.shape[1]
        return (k - ip) / k
    raise ValueError(f"{metric!r} is not an expanded metric")


def _elementwise_tile(xt: torch.Tensor, y: torch.Tensor, metric: str,
                      p: float) -> torch.Tensor:
    """An elementwise metric of a row tile (tm, k) against y (n, k) →
    (tm, n), through one (tm, n, k) broadcast."""
    a = xt.to(torch.float32)[:, None, :]
    b = y.to(torch.float32)[None, :, :]
    if metric == "l1":
        return (a - b).abs().sum(dim=-1)
    if metric == "chebyshev":
        return (a - b).abs().amax(dim=-1)
    if metric == "minkowski":
        return ((a - b).abs() ** p).sum(dim=-1) ** (1.0 / p)
    if metric == "canberra":
        den = a.abs() + b.abs()
        return torch.where(den > 0, (a - b).abs() / torch.clamp(den, min=1e-30),
                           0.0).sum(dim=-1)
    if metric == "braycurtis":
        num = (a - b).abs().sum(dim=-1)
        den = (a + b).abs().sum(dim=-1)
        return torch.where(den > 0, num / torch.clamp(den, min=1e-30), 0.0)
    if metric == "hamming":
        return (a != b).to(torch.float32).mean(dim=-1)

    def plogq(u, v):
        return torch.where(u > 0, u * torch.log(torch.clamp(u, min=1e-30)
                                                / torch.clamp(v, min=1e-30)),
                           0.0)
    if metric == "jensenshannon":
        m = 0.5 * (a + b)
        js = 0.5 * (plogq(a, m) + plogq(b, m)).sum(dim=-1)
        return torch.sqrt(torch.clamp(js, min=0.0))
    if metric == "kl_divergence":
        return plogq(a, b).sum(dim=-1)
    raise ValueError(f"{metric!r} is not an elementwise metric")


def row_tile_size(n: int, k: int, workspace_bytes: int) -> int:
    """Rows of x per elementwise tile: the (tm, n, k) fp32 block within the
    workspace, at most 4096."""
    return int(min(max(1, workspace_bytes // max(1, n * k * 4)), 4096))


def haversine(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Great-circle distance between (lat, lon) radian pairs."""
    if x.shape[1] != 2 or y.shape[1] != 2:
        raise ValueError("haversine requires 2-d (lat, lon) inputs")
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    lat1, lon1 = x[:, 0][:, None], x[:, 1][:, None]
    lat2, lon2 = y[:, 0][None, :], y[:, 1][None, :]
    a = (torch.sin(0.5 * (lat2 - lat1)) ** 2
         + torch.cos(lat1) * torch.cos(lat2)
         * torch.sin(0.5 * (lon2 - lon1)) ** 2)
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def metric_block(x: torch.Tensor, y: torch.Tensor, metric: str, p: float,
                 compute_dtype: Optional[torch.dtype] = None
                 ) -> torch.Tensor:
    """Distances of rows ``x`` against rows ``y`` under one canonical metric,
    in one block (callers tile)."""
    if metric == "haversine":
        return haversine(x, y)
    if metric in EXPANDED_METRICS:
        return _expanded_distance(x, y, metric, compute_dtype)
    return _elementwise_tile(x, y, metric, p)


def pairwise_distance(x, y, metric: str = "sqeuclidean", p: float = 2.0,
                      res: Optional[Resources] = None,
                      device: Optional[DeviceLike] = None) -> torch.Tensor:
    """All-pairs distances (m, n) between the rows of x (m, k) and y (n, k)
    under any metric of :data:`ALL_METRICS` or an alias; ``p`` is
    minkowski's order. The expanded metrics are one fp32 gemm (bf16 inputs
    with ``res.compute_dtype``); the elementwise ones run in row tiles
    sized by ``res.workspace_bytes``."""
    res = resources_for(device, res)
    metric = canonical_metric(metric)
    x = torch.as_tensor(x).to(res.device)
    y = torch.as_tensor(y).to(res.device)
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"shape mismatch: {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    if metric in EXPANDED_METRICS or metric == "haversine":
        return metric_block(x, y, metric, float(p), res.compute_dtype)
    tm = row_tile_size(y.shape[0], y.shape[1], res.workspace_bytes)
    return torch.cat([_elementwise_tile(x[s:s + tm], y, metric, float(p))
                      for s in range(0, x.shape[0], tm)]) \
        if x.shape[0] else torch.zeros((0, y.shape[0]), device=res.device)
