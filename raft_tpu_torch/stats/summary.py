"""Summary statistics (counterpart of ``raft_tpu/stats/summary.py``); the
port has ``cov`` so far, which CAGRA's PCA projection uses."""

from __future__ import annotations

import torch


def cov(x: torch.Tensor, mu=None, sample: bool = True,
        stable: bool = True) -> torch.Tensor:
    """Covariance matrix of row-sample data ``(n, d) -> (d, d)``, the JAX
    package's ``cov``: divided by n − 1 with ``sample`` (the default), by n
    without; ``mu`` is the column mean unless given. ``stable`` centres
    first; otherwise E[xy] − E[x]E[y]. The products are fp32 gemms (TF32
    off)."""
    n = x.shape[0]
    denom = max(n - 1, 1) if sample else n
    if mu is None:
        mu = torch.mean(x, dim=0)
    mu = torch.as_tensor(mu, dtype=x.dtype, device=x.device)
    if stable:
        xc = x - mu[None, :]
        return (xc.T @ xc) / denom
    exy = (x.T @ x) / denom
    return exy - torch.outer(mu, mu) * (n / denom)
