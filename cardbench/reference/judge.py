"""The comparison that decides ``correct`` for a search cell.

It reads the program's answers only to judge them, and works everything
else out again from the benchmark's own rows, queries and filter mask:

* ``recall_at_10``: over every query answered in the window, the share of
  its k returned ids whose exact distance is within the k-th exact
  neighbour's (ann-benchmarks' rule: ties count), each id once; at least
  the limit the configuration states (its recall gate);
* ``malformed``: returned ids out of range or repeated in a row, over every
  answer; and in the sampled answers, distances that are not ascending or
  not finite where an id was returned: none allowed;
* ``dist_err``: in a sample of the window's answers drawn from the seed,
  the widest gap between a returned distance and the float64 distance of
  the returned id, over ‖q‖² + ‖x‖² (the size of the terms a float32
  distance cancels);
* ``filter_violations`` (filtered cells): returned ids that the filter
  fails, over every answer: none allowed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cardbench.harness import check
from cardbench.reference import knn

#: relative slack on the k-th neighbour's distance in the recall count
RECALL_TIE_REL = 1e-6


def repeated(ids: torch.Tensor) -> torch.Tensor:
    """(q, k) bool: the id at j also stands at some i < j of its row."""
    eq = ids[:, :, None] == ids[:, None, :]
    return torch.triu(eq, diagonal=1).any(1)


def recall_hits(rows, queries, ids, kth) -> int:
    """Returned ids (each counted once) whose exact distance is within the
    k-th exact neighbour's."""
    d = knn.exact_distances(rows, queries, ids)
    near = d <= kth[:, None] * (1.0 + RECALL_TIE_REL)
    return int((near & ~repeated(ids)).sum())


def malformed_ids(ids: torch.Tensor, n: int) -> int:
    bad = (ids < -1) | (ids >= n) | (repeated(ids) & (ids >= 0))
    return int(bad.sum())


def malformed_dists(d: torch.Tensor, ids: torch.Tensor) -> int:
    """Distances that are not finite where an id came back, or not
    ascending along a row."""
    returned = ids >= 0
    bad = int((returned & ~torch.isfinite(d)).sum())
    dd = torch.where(returned, d, torch.full_like(d, float("inf")))
    return bad + int((dd[:, 1:] < dd[:, :-1]).sum())


def judge_search(rows: torch.Tensor, pool: Sequence[torch.Tensor], k: int,
                 responses: Dict[int, List[Tuple[np.ndarray, int]]],
                 sample: List[Tuple[int, torch.Tensor, torch.Tensor]],
                 limits: dict, requests: int,
                 mask: Optional[torch.Tensor] = None):
    """→ (checks, recall). ``pool``: the query batches; ``responses``: per
    pool batch, each distinct host id array (q, k) returned for it and how
    many times; ``sample``: (pool batch, distances, ids) of the sampled
    answers; ``requests``: the answers the window gave."""
    dev = rows.device
    n = rows.shape[0]
    queries = torch.cat(list(pool))
    gt_d, _ = knn.exact_knn(rows, queries, k, mask)
    kth = gt_d[:, k - 1]
    starts = np.cumsum([0] + [int(b.shape[0]) for b in pool])
    hits = answered = malformed = violations = 0
    for b, answers in responses.items():
        qb, kb = pool[b], kth[starts[b]:starts[b + 1]]
        for ids_h, count in answers:
            ids = torch.from_numpy(np.asarray(ids_h)).to(dev).to(torch.int64)
            hits += count * recall_hits(rows, qb, ids[:, :k], kb)
            answered += count * ids.shape[0]
            malformed += count * malformed_ids(ids, n)
            if mask is not None:
                ok = (ids >= 0) & (ids < n)
                violations += count * int(
                    (ok & ~mask[ids.clamp(0, n - 1)]).sum())
    dist_err = 0.0
    for b, d, ids in sample:
        ids = ids.to(torch.int64)
        malformed += malformed_dists(d, ids)
        ref = knn.exact_distances(rows, pool[b], ids)
        size = knn.scale(rows, pool[b], ids)
        returned = ids >= 0
        if bool(returned.any()):
            gap = (d.to(torch.float64) - ref).abs() / size.clamp(min=1e-300)
            dist_err = max(dist_err, float(gap[returned].max()))
    recall = hits / (answered * k) if answered else 0.0
    checks = [check("requests", requests, ">=", 1),
              check("recall_at_10", recall, ">=", limits["recall_at_10"]),
              check("malformed", malformed, "<=", 0),
              check("dist_err", dist_err, "<=", limits["dist_err"])]
    if mask is not None:
        checks.append(check("filter_violations", violations, "<=", 0))
    return checks, recall
