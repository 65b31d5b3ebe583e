"""Distance primitives the main path needs (counterpart of
``raft_tpu/ops/distance.py``): squared norms, ``x @ y.T`` with fp32
accumulation, and the tiled nearest-center argmin that k-means assigns with.

fp32 products are full fp32: TF32 is off (``core/resources.py``), which is
the port's form of the reference's ``precision="highest"``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_ALIASES = {"l2": "sqeuclidean", "l2_expanded": "sqeuclidean",
            "euclidean_expanded": "euclidean", "l2sqrt": "euclidean",
            "ip": "inner_product", "dot": "inner_product"}


def canonical_metric(metric: str) -> str:
    m = metric.lower()
    return _ALIASES.get(m, m)


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


def fused_l2_nn_argmin(x: torch.Tensor, y: torch.Tensor,
                       workspace_bytes: int = 1 << 30
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row nearest row of ``y`` under L2: (min d², int64 argmin), tiled
    over ``x`` so that no (tile, n_y) fp32 block exceeds the workspace.
    Ties go to the lowest index, as ``jnp.argmin``."""
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
        vals.append(v)
        idxs.append(i)
    return torch.cat(vals), torch.cat(idxs)
