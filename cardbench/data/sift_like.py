"""SIFT-shaped synthetic rows, drawn on the device.

A frozen copy of the mixture of ``raft_tpu_torch/bench/datasets.py``
``sift_like`` (commit c6c242d), rewritten to draw with a
``torch.Generator`` on the run's device in a few large calls instead of
numpy on one host core: a two-level Zipf(0.7)-weighted mixture of
``max(64, min(4096, n // 256))`` anisotropic clusters (centres N(0, 4),
spreads uniform in [0.5, 2.0]), mixed through a random orthogonal basis
with the decaying spectrum 1/sqrt(1 + j/8), rectified, scaled so that the
99.5th percentile of the rows lands at 110, and clipped to uint8. The
mixture and the rows come from the configuration's data seed, the queries
from the run's seed; both follow one mixture, the queries stratified over
its components (:func:`cardbench.data.stratified`). The same seeds give the
same rows and queries on the same device; the draws differ from numpy's."""

from __future__ import annotations

import torch

from cardbench.data import stratified
from cardbench.reference.precision import highest_precision


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """numpy's default (linear) percentile of all of ``x``."""
    flat = torch.sort(x.reshape(-1)).values
    pos = (q / 100.0) * (flat.numel() - 1)
    lo = int(pos)
    hi = min(lo + 1, flat.numel() - 1)
    return flat[lo] + (flat[hi] - flat[lo]) * (pos - lo)


def make(spec: dict, n_queries: int, query_seed: int, device):
    """(rows uint8 (n, dim), queries uint8 (n_queries, dim)) on ``device``.
    The mixture and the rows come from ``spec["seed"]``, so every run
    serves the same rows; the queries are fresh draws from the same
    mixture, from ``query_seed``, each component drawn as often whatever
    the seed."""
    n, dim = int(spec["rows"]), int(spec["dim"])
    g = torch.Generator(device=device)
    g.manual_seed(int(spec["seed"]))
    n_coarse = max(64, min(4096, n // 256))
    w = 1.0 / torch.arange(1, n_coarse + 1, dtype=torch.float64,
                           device=device) ** 0.7
    w = w / w.sum()
    centers = torch.randn(n_coarse, dim, generator=g, device=device) * 2.0
    spread = 0.5 + torch.rand(n_coarse, dim, generator=g, device=device) * 1.5
    with highest_precision():
        basis = torch.linalg.qr(torch.randn(dim, dim, generator=g,
                                            device=device))[0]
    spectrum = 1.0 / torch.sqrt(1.0 + torch.arange(
        dim, dtype=torch.float32, device=device) / 8.0)
    mix = basis * spectrum[None, :]

    def draw(count: int, gen: torch.Generator, assign=None) -> torch.Tensor:
        if assign is None:
            assign = torch.multinomial(w, count, replacement=True,
                                       generator=gen)
        x = torch.randn(count, dim, generator=gen, device=device)
        x = centers[assign] + x * spread[assign]
        with highest_precision():
            x = x @ mix
        return torch.clamp_(x, min=0.0)

    rows = draw(n, g)
    gq = torch.Generator(device=device)
    gq.manual_seed(query_seed)
    queries = draw(n_queries, gq, stratified(w, n_queries, gq))
    scale = 110.0 / torch.clamp(percentile(rows, 99.5), min=1e-6)
    return (torch.clamp_(rows * scale, 0, 255).to(torch.uint8),
            torch.clamp_(queries * scale, 0, 255).to(torch.uint8))
