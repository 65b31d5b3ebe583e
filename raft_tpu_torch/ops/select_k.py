"""Top-k selection (counterpart of ``raft_tpu/ops/select_k.py``).

The JAX package runs k masked-min passes because a sort is slow on the TPU;
the selections they define are simple orders, and the port computes them by
sorting:

* ``iter_topk_min`` — ascending values, lowest index on ties, distinct
  indices even on +inf tails, NaN → +inf: exactly a stable ascending sort.
* ``iter_topk_min_packed`` — the column index rides the low mantissa bits
  (``pack_values``), which makes every packed value in a row unique, so the
  k smallest packed values are one well-defined set: bit for bit the JAX
  result.
* ``select_k(..., algo="exact")`` — a stable sort, which reproduces
  ``lax.top_k``'s lowest-index tie order (``torch.topk`` does not promise
  one). ``algo="approx"`` runs the same exact select: an exact select meets
  any ``recall_target``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _sanitize(values: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(values), torch.full_like(values, float("inf")),
                       values)


def iter_topk_min(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest along the last axis: (vals, int32 idx), ascending, lowest
    index on ties, NaN treated as +inf."""
    v = _sanitize(values) if values.is_floating_point() else values
    vals, idx = torch.sort(v, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def _pack_bits_for(n: int) -> int:
    b = 1
    while (1 << b) < n:
        b += 1
    return b


def pack_clamp_for(bits: int) -> float:
    """Largest finite fp32 whose truncated mantissa survives OR-ing any
    ``bits``-wide index without overflowing into the exponent."""
    return float(np.array((0x7F7FFFFF >> bits) << bits, np.uint32)
                 .view(np.float32))


def pack_values(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack per-position column ids into the low ``bits`` mantissa bits of
    fp32 ``v`` (last axis). NaN → +inf → clamped; ±inf → ±clamp; packed
    values within a row are unique."""
    clamp = pack_clamp_for(bits)
    mask = (1 << bits) - 1
    v = _sanitize(v.to(torch.float32))
    v = torch.clamp(v, -clamp, clamp)
    cols = torch.arange(v.shape[-1], dtype=torch.int32, device=v.device)
    return ((v.view(torch.int32) & ~mask) | cols).view(torch.float32)


def order_key(pv: torch.Tensor) -> torch.Tensor:
    """int64 key whose integer order is the float order of ``pv`` (exact
    on denormals, which packed values near zero are)."""
    b = pv.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = b >= 0x80000000
    return torch.where(neg, 0xFFFFFFFF - b, b + 0x80000000)


def iter_topk_min_packed(values: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bit-exact counterpart of the JAX packed select: values perturbed by
    ≤ 2^-(23-b) relative (b = ceil(log2 n) index bits); ±inf restored."""
    v = values.to(torch.float32)
    b = _pack_bits_for(v.shape[-1])
    mask = (1 << b) - 1
    clamp = pack_clamp_for(b)
    pv = pack_values(v, b)
    _, order = torch.sort(order_key(pv), dim=-1)
    top = torch.gather(pv, -1, order[..., :k]).view(torch.int32)
    idx = top & mask
    out_v = (top & ~mask).view(torch.float32)
    inf = torch.full_like(out_v, float("inf"))
    out_v = torch.where(out_v >= clamp, inf, out_v)
    out_v = torch.where(out_v <= -clamp, -inf, out_v)
    return out_v, idx


def select_k(values: torch.Tensor, k: int, select_min: bool = True,
             indices: Optional[torch.Tensor] = None, algo: str = "exact",
             recall_target: float = 0.95
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest (or largest) per row of ``values`` (batch, n) →
    (values, int32 indices); with ``indices`` the winners' ids are gathered
    from it. ``algo``: "exact" or "iter" (both a stable sort: lowest index on
    ties), "packed" (``iter_topk_min_packed``) or "approx" (the JAX
    package's partial reduce, which trades recall for speed on the TPU;
    here the exact select, which meets any ``recall_target``)."""
    squeeze = values.ndim == 1
    if squeeze:
        values = values[None, :]
    if not 0 < k <= values.shape[-1]:
        raise ValueError(f"k={k} out of range for n={values.shape[-1]}")
    if algo not in ("exact", "iter", "approx", "packed"):
        raise ValueError(f"unknown select_k algo {algo!r}")
    x = values if select_min else -values
    # wide rows would steal real mantissa bits (the JAX package's same cap)
    if algo == "packed" and x.is_floating_point() and x.shape[-1] <= (1 << 13):
        vals, idx = iter_topk_min_packed(x, k)
    else:
        vals, idx = iter_topk_min(x, k)
    if not select_min:
        vals = -vals
    if indices is not None:
        if squeeze and indices.ndim == 1:
            indices = indices[None, :]
        idx = torch.gather(indices, 1, idx.long())
    if squeeze:
        return vals[0], idx[0]
    return vals, idx
