"""Summary statistics (counterpart of ``raft_tpu/stats/summary.py``): sums,
means, variances, covariance, min/max, histograms, weighted means,
dispersion, entropy, KL divergence and information criteria.

The semantics are the JAX package's: sample variance (n − 1) by default,
``axis=0`` for per-column statistics, a histogram that truncates toward
zero before it clamps into the edge bins, an entropy over
``jnp.bincount(length=n)``'s bins (negative labels in bin 0, labels ≥ n
dropped). Every entry point added here takes ``device=None, res=None`` and
moves its operands to the resolved device (``cov`` predates them and
keeps its operand's device).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.resources import (DeviceLike, Resources,
                                           resolve_device, to_device)


def _on(x, device, res) -> torch.Tensor:
    return to_device(x, resolve_device(device, res))


def _float(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_floating_point() else x.to(torch.float32)


def sum_(x, axis: int = 0, device: Optional[DeviceLike] = None,
         res: Optional[Resources] = None) -> torch.Tensor:
    """Column (``axis=0``) or row (``axis=1``) sums; integer inputs sum to
    int32, as under JAX's default 32-bit integers."""
    x = _on(x, device, res)
    out = torch.sum(x, dim=axis)
    return out if x.is_floating_point() else out.to(torch.int32)


def mean(x, axis: int = 0, device: Optional[DeviceLike] = None,
         res: Optional[Resources] = None) -> torch.Tensor:
    """Column or row means."""
    return torch.mean(_float(_on(x, device, res)), dim=axis)


def mean_center(x, mu=None, axis: int = 0,
                device: Optional[DeviceLike] = None,
                res: Optional[Resources] = None) -> torch.Tensor:
    """``x`` minus its per-column (``axis=0``) or per-row means (or
    ``mu``)."""
    x = _float(_on(x, device, res))
    mu = torch.mean(x, dim=axis) if mu is None else \
        to_device(mu, x.device)
    return x - mu.unsqueeze(axis)


def mean_add(x, mu, axis: int = 0, device: Optional[DeviceLike] = None,
             res: Optional[Resources] = None) -> torch.Tensor:
    """The inverse of :func:`mean_center`."""
    x = _on(x, device, res)
    return x + to_device(mu, x.device).unsqueeze(axis)


def vars_(x, mu=None, sample: bool = True, axis: int = 0,
          device: Optional[DeviceLike] = None,
          res: Optional[Resources] = None) -> torch.Tensor:
    """Per-column or per-row variance, over n − 1 with ``sample``."""
    x = _float(_on(x, device, res))
    n = x.shape[axis]
    if mu is None:
        mu = torch.mean(x, dim=axis)
    d = x - to_device(mu, x.device).unsqueeze(axis)
    return torch.sum(d * d, dim=axis) / (max(n - 1, 1) if sample else n)


def stddev(x, mu=None, sample: bool = True, axis: int = 0,
           device: Optional[DeviceLike] = None,
           res: Optional[Resources] = None) -> torch.Tensor:
    """Per-column or per-row standard deviation."""
    return torch.sqrt(vars_(x, mu, sample, axis, device, res))


def meanvar(x, sample: bool = True, axis: int = 0,
            device: Optional[DeviceLike] = None,
            res: Optional[Resources] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, variance) along ``axis``."""
    x = _float(_on(x, device, res))
    mu = torch.mean(x, dim=axis)
    return mu, vars_(x, mu, sample, axis, x.device)


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


def minmax(x, axis: int = 0, device: Optional[DeviceLike] = None,
           res: Optional[Resources] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column or per-row (min, max)."""
    x = _on(x, device, res)
    return torch.amin(x, dim=axis), torch.amax(x, dim=axis)


def histogram(x, n_bins: int, lower: float, upper: float,
              device: Optional[DeviceLike] = None,
              res: Optional[Resources] = None) -> torch.Tensor:
    """Per-column histograms of ``(n, d)`` data → ``(n_bins, d)`` int32
    over ``n_bins`` equal bins of ``[lower, upper)``: a sample's bin is
    ``(x − lower) / width`` truncated toward zero, then clamped into
    ``[0, n_bins)`` (out-of-range samples land in the edge bins)."""
    x = _on(x, device, res)
    if x.ndim == 1:
        x = x[:, None]
    if n_bins <= 0:
        raise ValueError("n_bins must be positive")
    width = (upper - lower) / n_bins
    b = torch.clamp(((x - lower) / width).to(torch.int32), 0, n_bins - 1)
    d = x.shape[1]
    cols = torch.arange(d, device=x.device, dtype=torch.int64)
    cells = torch.bincount((cols[None, :] * n_bins + b).reshape(-1),
                           minlength=d * n_bins)
    return cells.reshape(d, n_bins).T.to(torch.int32)


def weighted_mean(x, weights, axis: int = 0,
                  device: Optional[DeviceLike] = None,
                  res: Optional[Resources] = None) -> torch.Tensor:
    """Weighted column (``axis=0``) or row (``axis=1``) means; ``weights``
    (``x.shape[axis]``,) is normalised by its sum."""
    x = _float(_on(x, device, res))
    w = to_device(weights, x.device)
    if tuple(w.shape) != (x.shape[axis],):
        raise ValueError(f"weights must be ({x.shape[axis]},), "
                         f"got {tuple(w.shape)}")
    w = w.to(x.dtype)
    return torch.tensordot(w, x, dims=([0], [axis])) / torch.sum(w)


def dispersion(centroids, cluster_sizes, global_centroid=None,
               device: Optional[DeviceLike] = None,
               res: Optional[Resources] = None) -> torch.Tensor:
    """Cluster dispersion ``sqrt(Σ_i size_i·‖c_i − mu‖²)``, ``mu`` the
    size-weighted mean of the centroids unless given."""
    c = _on(centroids, device, res).to(torch.float32)
    sizes = to_device(cluster_sizes, c.device)
    if global_centroid is not None:
        mu = to_device(global_centroid, c.device)
    else:
        mu = torch.sum(c * sizes[:, None], dim=0) \
            / torch.clamp(torch.sum(sizes), min=1)
    d = c - mu[None, :]
    return torch.sqrt(torch.sum(torch.sum(d * d, dim=1) * sizes))


def entropy(labels, n_classes: int, device: Optional[DeviceLike] = None,
            res: Optional[Resources] = None) -> torch.Tensor:
    """Shannon entropy (nats) of integer labels over ``n_classes`` bins:
    negative labels count in bin 0 and labels ≥ ``n_classes`` in none
    (``jnp.bincount(length=n)``)."""
    lab = _on(labels, device, res).reshape(-1).to(torch.int64)
    lab = torch.clamp(lab, min=0)
    counts = torch.bincount(lab[lab < n_classes], minlength=n_classes)
    p = counts.to(torch.float32) / torch.clamp(counts.sum(), min=1)
    return -torch.sum(p * torch.log(torch.where(p > 0, p,
                                                torch.ones_like(p))))


def kl_divergence(p, q, device: Optional[DeviceLike] = None,
                  res: Optional[Resources] = None) -> torch.Tensor:
    """``KL(p ‖ q) = Σ p·log(p/q)``; terms with p ≤ 0 count 0."""
    p = _on(p, device, res)
    q = to_device(q, p.device)
    ratio = torch.where(p > 0, p / q, torch.ones_like(p))
    return torch.sum(torch.where(p > 0, p * torch.log(ratio),
                                 torch.zeros_like(p)))


def information_criterion(log_likelihood, ic_type: str, n_params: int,
                          n_samples: int,
                          device: Optional[DeviceLike] = None,
                          res: Optional[Resources] = None) -> torch.Tensor:
    """AIC, AICc or BIC of per-series log-likelihoods: ``base − 2·ll``
    with base ``2n``, ``2(n + n(n+1)/(t − n − 1))`` or ``log(t)·n`` (a host
    ``log``)."""
    ll = _on(log_likelihood, device, res)
    n, t = float(n_params), float(n_samples)
    if ic_type == "aic":
        base = 2.0 * n
    elif ic_type == "aicc":
        base = 2.0 * (n + (n * (n + 1.0)) / (t - n - 1.0))
    elif ic_type == "bic":
        base = math.log(t) * n
    else:
        raise ValueError(f"unknown ic_type {ic_type!r} (aic|aicc|bic)")
    return base - 2.0 * ll
