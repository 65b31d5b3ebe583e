"""Generators of the benchmark's rows and queries, drawn on the device: one
module per recipe, found by the configuration's ``data.recipe``. Frozen
copies: the port's own generators may change, these may not."""

from __future__ import annotations

import torch


def stratified(weights: torch.Tensor, count: int,
               gen: torch.Generator) -> torch.Tensor:
    """``count`` mixture components, each ``floor(w * count)`` times plus
    one for the largest remainders, in an order ``gen`` draws: every seed
    draws the same number of queries from each component, so the work a
    query pool asks for does not hang on its seed."""
    exact = weights.to(torch.float64) * count
    n = torch.floor(exact).to(torch.int64)
    short = count - int(n.sum())
    if short:
        n[torch.argsort(exact - n, descending=True, stable=True)[:short]] += 1
    comps = torch.repeat_interleave(
        torch.arange(weights.shape[0], device=weights.device), n)
    return comps[torch.randperm(count, generator=gen, device=weights.device)]
