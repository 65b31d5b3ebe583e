"""Shared filter plumbing for the IVF families (counterpart of
``raft_tpu/neighbors/_filtering.py``).

* The filter→bias rule (:func:`apply_filter_bias`): a filtered-out row is
  a ``+inf`` bias lane, the tombstone mechanism generalised. Kernels K1–K4
  already take the bias, and their plans skip sub-blocks whose lanes are
  all dead (``strip_scan.sub_block_liveness``, ``paged_sub_live``), so a
  filter needs no other kernel operand. Out-of-range ids fail the test,
  so rows minted after the mask was built are excluded.
* The selectivity→widening rule (:func:`widen_plan`): ``n_probes`` (and a
  refine path's over-fetch ``k_fetch``) scale by ``min(1/pass_rate,
  RAFT_TPU_FILTER_MAX_WIDEN)``, so k survivors come back at selective
  filters.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch

FILTER_MAX_WIDEN_ENV = "RAFT_TPU_FILTER_MAX_WIDEN"


def default_filter_max_widen() -> float:
    """Cap on the widening factor (``RAFT_TPU_FILTER_MAX_WIDEN``, default
    8)."""
    return float(os.environ.get(FILTER_MAX_WIDEN_ENV, "8"))


def apply_filter_bias(bias: torch.Tensor, ids: torch.Tensor, filter):
    """``bias`` with ``+inf`` where the row id fails ``filter``. ``ids``
    hold -1 at padding; they are clamped to 0 for the test, and padding
    stays dead because its bias is already ``+inf``. ``bias`` itself when
    ``filter`` is None."""
    if filter is None:
        return bias
    return torch.where(filter.test(torch.clamp(ids, min=0)), bias,
                       float("inf"))


def widen_plan(filter, n_probes: int, n_lists: int,
               k_fetch: Optional[int] = None, k_cap: Optional[int] = None,
               max_widen: Optional[float] = None
               ) -> Tuple[int, Optional[int], float, float]:
    """→ ``(n_probes_eff, k_fetch_eff, pass_rate, widen)``: the identity
    without a filter; else ``widen = min(1/pass_rate, max_widen)`` (at
    least 1; ``max_widen`` defaults to :func:`default_filter_max_widen`),
    ``n_probes`` scaled and clamped to ``n_lists``, ``k_fetch`` (when
    given) scaled, clamped to ``k_cap`` and never below itself."""
    if filter is None:
        return int(n_probes), k_fetch, 1.0, 1.0
    rate = float(filter.pass_rate())
    cap = default_filter_max_widen() if max_widen is None else float(max_widen)
    widen = max(min(max(cap, 1.0), 1.0 / max(rate, 1e-9)), 1.0)
    n_probes_eff = int(min(n_lists, math.ceil(n_probes * widen)))
    k_fetch_eff = k_fetch
    if k_fetch is not None:
        k_fetch_eff = int(math.ceil(k_fetch * widen))
        if k_cap is not None:
            k_fetch_eff = min(int(k_cap), k_fetch_eff)
        k_fetch_eff = max(int(k_fetch), k_fetch_eff)
    return n_probes_eff, k_fetch_eff, rate, widen
