"""Kernel-method Gram matrices (counterpart of ``raft_tpu/ops/kernels.py``):
linear, polynomial, tanh and RBF kernels and the masked L2 nearest
neighbour.

Each Gram kernel is one fp32 product (``distance.matmul_t``, or the
expanded squared L2 of ``pairwise_distance``) and an elementwise epilogue;
no Pallas kernel stands behind them in the JAX package, so none stands
behind them here. ``masked_l2_nn`` tiles the rows of ``x`` by
``res.workspace_bytes`` where the JAX package builds the whole (m, n)
block. Every entry point takes ``device=None, res=None`` and moves its
operands to the resolved device.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.resources import (DeviceLike, Resources,
                                           resources_for, to_device)
from raft_tpu_torch.ops import distance as dist_mod


def _rows(x, res: Resources) -> torch.Tensor:
    return to_device(x, res.device).to(torch.float32)


def linear_kernel(x, y, device: Optional[DeviceLike] = None,
                  res: Optional[Resources] = None) -> torch.Tensor:
    """``K = X·Yᵀ`` (fp32; bf16 inputs under ``res.compute_dtype``)."""
    res = resources_for(device, res)
    return dist_mod.matmul_t(_rows(x, res), _rows(y, res), res.compute_dtype)


def polynomial_kernel(x, y, degree: int = 3, gain: float = 1.0,
                      offset: float = 0.0,
                      device: Optional[DeviceLike] = None,
                      res: Optional[Resources] = None) -> torch.Tensor:
    """``K = (gain·X·Yᵀ + offset)^degree``."""
    return (gain * linear_kernel(x, y, device, res) + offset) ** degree


def tanh_kernel(x, y, gain: float = 1.0, offset: float = 0.0,
                device: Optional[DeviceLike] = None,
                res: Optional[Resources] = None) -> torch.Tensor:
    """``K = tanh(gain·X·Yᵀ + offset)``."""
    return torch.tanh(gain * linear_kernel(x, y, device, res) + offset)


def rbf_kernel(x, y, gain: float = 1.0, device: Optional[DeviceLike] = None,
               res: Optional[Resources] = None) -> torch.Tensor:
    """``K = exp(−gain·‖x − y‖²)``, the squared distance clamped at 0."""
    res = resources_for(device, res)
    d2 = dist_mod.pairwise_distance(x, y, "sqeuclidean", res=res)
    return torch.exp(-gain * torch.clamp(d2, min=0.0))


def masked_l2_nn(x, y, adj, group_idx, sqrt: bool = False,
                 device: Optional[DeviceLike] = None,
                 res: Optional[Resources] = None):
    """Masked fused L2 nearest neighbour: for each row i of ``x`` the
    argmin over the rows j of ``y`` with ``adj[i, group_idx[j]]`` true →
    ``(min distances (m,), argmins (m,) int32)``, +inf and −1 where a row
    admits nothing, the lowest j at ties. The rows of ``x`` go in tiles of
    at most ``res.workspace_bytes`` of fp32 distances."""
    res = resources_for(device, res)
    dev = res.device
    x, y = _rows(x, res), _rows(y, res)
    adj = to_device(adj, dev).to(torch.bool)
    group_idx = to_device(group_idx, dev).to(torch.int64)
    if group_idx.shape[0] != y.shape[0]:
        raise ValueError("group_idx must have one entry per y row")
    if adj.ndim != 2 or adj.shape[0] != x.shape[0]:
        raise ValueError("adj must be (x_rows, n_groups)")
    groups = torch.clamp(group_idx, 0, adj.shape[1] - 1)
    n = y.shape[0]
    tile = max(1, res.workspace_bytes // max(1, 4 * n))
    mins, args = [], []
    for s in range(0, x.shape[0], tile):
        d = dist_mod.pairwise_distance(x[s:s + tile], y, "sqeuclidean",
                                       res=res)
        d = torch.where(adj[s:s + tile][:, groups], d, float("inf"))
        m, a = torch.min(d, dim=1)
        mins.append(m)
        args.append(torch.where(torch.isfinite(m), a, -1).to(torch.int32))
    mins = torch.cat(mins) if mins else torch.zeros(0, device=dev)
    args = torch.cat(args) if args else torch.zeros(0, dtype=torch.int32,
                                                    device=dev)
    if sqrt:
        mins = torch.sqrt(torch.clamp(mins, min=0.0))
    return mins, args
