"""Percentile bounds from power-of-two histograms (the part of
``raft_tpu/obs/aggregate.py`` the registry needs). Stdlib only."""

from __future__ import annotations

import math

__all__ = ["QUANTILES", "percentile_bounds"]

#: the quantiles snapshot() carries, as (key, q) pairs
QUANTILES = (("p50_ub", 0.50), ("p90_ub", 0.90), ("p99_ub", 0.99))


def percentile_bounds(buckets: dict, count: int) -> dict:
    """p50/p90/p99 UPPER-BOUND estimates from power-of-two buckets.

    A bucket key ``le_B`` counts observations with value ≤ B where B is the
    smallest power of two ≥ the value — so the true q-quantile lies in
    ``(B/2, B]`` of the first bucket whose cumulative count reaches
    ``ceil(q·count)``, and the returned bound over-estimates it by at most
    2×. Returns ``{}`` for an empty histogram."""
    if not count or not buckets:
        return {}
    bounds = []
    for key, n in buckets.items():
        try:
            bounds.append((float(str(key)[3:]), int(n)))
        except (ValueError, IndexError):
            continue
    if not bounds:
        return {}
    bounds.sort()
    out = {}
    for key, q in QUANTILES:
        need = max(1, math.ceil(q * count))
        cum = 0
        for bound, n in bounds:
            cum += n
            if cum >= need:
                out[key] = bound
                break
        else:
            out[key] = bounds[-1][0]
    return out
