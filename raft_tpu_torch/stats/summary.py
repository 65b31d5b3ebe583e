"""Summary statistics (counterpart of ``raft_tpu/stats/summary.py``); this
slice needs only ``cov``, for CAGRA's PCA projection."""

from __future__ import annotations

import torch


def cov(x: torch.Tensor) -> torch.Tensor:
    """Population covariance of row-sample data ``(n, d) -> (d, d)``, mean
    centred first: the JAX package's ``cov(x, sample=False)``. The product
    is one fp32 gemm (TF32 off)."""
    xc = x - torch.mean(x, dim=0)[None, :]
    return (xc.T @ xc) / max(x.shape[0], 1)
