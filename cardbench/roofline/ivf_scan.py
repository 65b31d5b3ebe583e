"""The work of an IVF list scan (kernel K1 over the int8 residual cache),
counted from the task: each (query, probed list) pair scores every row of
the list that the filter passes, and each row's bytes are read once.

* operations: 2 · rot_dim per (query, row) pair scored;
* bytes: for each distinct list a batch probes, its live rows' cache
  (rot_dim int8) and scan bias (one float32); the queries in (rot_dim
  bf16 each) and the k_fetch candidates out (a float32 distance and an
  int32 id each).

The probes are the yardstick's own: the ``n_probes`` centres nearest each
query by exact float32 L2 (TF32 off), from the index's centres, and under
a filter the count widens as the configuration's rule states:
``ceil(n_probes · min(1 / pass rate, max_widen))``, at most ``n_lists``."""

from __future__ import annotations

import math
from typing import Optional

import torch

from cardbench.reference.precision import highest_precision


def widened(n_probes: int, n_lists: int, pass_rate: Optional[float],
            max_widen: float = 8.0) -> int:
    if pass_rate is None:
        return int(n_probes)
    widen = max(min(max_widen, 1.0 / max(pass_rate, 1e-9)), 1.0)
    return int(min(n_lists, math.ceil(n_probes * widen)))


def probes(queries: torch.Tensor, centers: torch.Tensor,
           n_probes: int) -> torch.Tensor:
    """(q, n_probes) int64: the nearest centres of each query."""
    with highest_precision():
        q = queries.to(torch.float32)
        c = centers.to(torch.float32)
        d = (c * c).sum(1)[None, :] - 2.0 * (q @ c.T)
    return torch.topk(d, n_probes, dim=1, largest=False).indices


def work(probe_ids: torch.Tensor, live_rows: torch.Tensor, rot_dim: int,
         k_fetch: int) -> dict:
    """{"flops", "bytes"} of one batch: ``probe_ids`` (q, p) int64,
    ``live_rows`` (n_lists,) int64, the rows each list holds that the
    filter passes."""
    q = probe_ids.shape[0]
    pairs_rows = int(live_rows[probe_ids].sum())
    listed = torch.unique(probe_ids)
    scanned_rows = int(live_rows[listed].sum())
    flops = 2.0 * rot_dim * pairs_rows
    nbytes = scanned_rows * (rot_dim + 4) + q * rot_dim * 2 + q * k_fetch * 8
    return {"flops": flops, "bytes": float(nbytes)}
