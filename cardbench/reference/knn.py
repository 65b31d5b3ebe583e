"""Exact k-nearest neighbours under squared L2, in plain PyTorch.

The scan runs in float32 (TF32 off) in blocks of rows and queries, keeps
the ``k + margin`` best of each query, and re-ranks those in float64 from
the rows themselves, so the answer does not hang on float32 rounding at
near-ties. :func:`scan` at a lower precision is the control: the same
search with its products computed from operands rounded to that precision.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cardbench.reference.precision import highest_precision, round_to

#: extra candidates the float32 scan keeps for the float64 re-rank
MARGIN = 10


def scan(rows: torch.Tensor, queries: torch.Tensor, n_best: int,
         mask: Optional[torch.Tensor] = None, precision: str = "fp32",
         q_block: int = 8192, r_block: int = 131072
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distances float32 (q, n_best), ids int64 (q, n_best)), ascending:
    ‖q‖² + ‖x‖² − 2⟨q, x⟩ over the rows that ``mask`` (bool, one per row)
    passes, every product from operands rounded to ``precision``; ids -1
    and +inf where fewer rows pass."""
    dev = rows.device
    n, q = rows.shape[0], queries.shape[0]
    qs = round_to(queries.to(torch.float32), precision)
    qn = (qs * qs).sum(1)
    best_d = torch.full((q, n_best), float("inf"), device=dev)
    best_i = torch.full((q, n_best), -1, dtype=torch.int64, device=dev)
    with highest_precision():
        for s in range(0, n, r_block):
            e = min(n, s + r_block)
            xr = round_to(rows[s:e].to(torch.float32), precision)
            xn = (xr * xr).sum(1)
            dead = None if mask is None else ~mask[s:e]
            kk = min(n_best, e - s)
            for a in range(0, q, q_block):
                b = min(q, a + q_block)
                d = torch.addmm(xn[None, :], qs[a:b], xr.T, alpha=-2.0)
                if dead is not None:
                    d.masked_fill_(dead[None, :], float("inf"))
                v, j = torch.topk(d, kk, dim=1, largest=False)
                del d
                v = torch.cat([best_d[a:b], v], 1)
                j = torch.cat([best_i[a:b], j + s], 1)
                v, sel = torch.topk(v, n_best, dim=1, largest=False)
                best_d[a:b] = v
                best_i[a:b] = torch.gather(j, 1, sel)
    best_i = torch.where(torch.isinf(best_d), torch.full_like(best_i, -1),
                         best_i)
    return best_d + qn[:, None], best_i


def exact_distances(rows: torch.Tensor, queries: torch.Tensor,
                    ids: torch.Tensor, block: int = 8192) -> torch.Tensor:
    """float64 squared distances (q, c) of each query to each of its ids,
    summed from the differences; +inf where an id is out of range."""
    n = rows.shape[0]
    out = []
    for a in range(0, queries.shape[0], block):
        i = ids[a:a + block].to(torch.int64)
        ok = (i >= 0) & (i < n)
        x = rows[i.clamp(0, n - 1)].to(torch.float64)
        qd = queries[a:a + block].to(torch.float64)
        d = ((x - qd[:, None, :]) ** 2).sum(-1)
        out.append(torch.where(ok, d, torch.full_like(d, float("inf"))))
    return torch.cat(out)


def scale(rows: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor,
          block: int = 8192) -> torch.Tensor:
    """float64 ‖q‖² + ‖x‖² of each query and each of its ids: the size of
    the terms that a distance computed as ‖q‖² + ‖x‖² − 2⟨q, x⟩ cancels."""
    n = rows.shape[0]
    out = []
    for a in range(0, queries.shape[0], block):
        i = ids[a:a + block].to(torch.int64).clamp(0, n - 1)
        x = rows[i].to(torch.float64)
        qd = queries[a:a + block].to(torch.float64)
        out.append((qd * qd).sum(-1)[:, None] + (x * x).sum(-1))
    return torch.cat(out)


def exact_knn(rows: torch.Tensor, queries: torch.Tensor, k: int,
              mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distances float64 (q, k), ids int64 (q, k)), ascending: the k rows
    nearest each query among those ``mask`` passes."""
    _, cand = scan(rows, queries, k + MARGIN, mask)
    d = exact_distances(rows, queries, cand)
    d, sel = torch.sort(d, dim=1, stable=True)
    return d[:, :k], torch.gather(cand, 1, sel[:, :k])
