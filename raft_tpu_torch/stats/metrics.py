"""Quality metrics (counterpart of ``raft_tpu/stats/metrics.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def neighborhood_recall(indices, ref_indices, distances=None,
                        ref_distances=None, eps: float = 0.001) -> float:
    """Recall of ANN results against ground truth: a column matches when
    its id is in the reference row or, with distances, when some reference
    distance is within relative ``eps`` (absolute below ``eps``). Rows are
    compared in tiles, so 10k × 10 results need no (q, k, k) block at once."""
    idx = torch.as_tensor(indices)
    ref = torch.as_tensor(ref_indices).to(idx.device)
    if idx.shape[0] != ref.shape[0]:
        raise ValueError("indices and ref_indices must have the same row count")
    if (distances is None) != (ref_distances is None):
        raise ValueError("distances and ref_distances must be provided together")
    hits = 0.0
    step = 4096
    for s in range(0, idx.shape[0], step):
        match = (idx[s:s + step, :, None] == ref[s:s + step, None, :]).any(2)
        if distances is not None:
            d = torch.as_tensor(distances).to(idx.device)[s:s + step, :, None]
            rd = torch.as_tensor(ref_distances).to(idx.device)[s:s + step, None, :]
            diff = (d - rd).abs()
            m = torch.maximum(d.abs(), rd.abs())
            ratio = torch.where(diff > eps, diff / m.clamp(min=1e-30), diff)
            match = match | (ratio <= eps).any(2)
        hits += float(match.to(torch.float32).sum())
    return hits / float(idx.numel())


def topk_agreement(v_ref: torch.Tensor, i_ref: torch.Tensor,
                   v_got: torch.Tensor, i_got: torch.Tensor,
                   rtol: float = 5e-4, atol: float = 0.0,
                   tie_rtol: float = 1e-3, max_mismatch: float = 0.05,
                   mask: Optional[torch.Tensor] = None) -> dict:
    """How far two ascending per-row top-k results agree when they should
    differ only by the order of fp32 sums: the ±inf pattern, finite values
    within ``atol + rtol·|v|``, and ids equal except at near-ties — a
    position may hold another id only where the two values there agree
    within ``atol + tie_rtol·|v|`` (two candidates that tie), and on at
    most a ``max_mismatch`` share of the positions, so that right values
    under wrong ids cannot pass. ``mask`` (rows) limits the comparison.
    Returns counts and worst errors; ``ok`` is their verdict."""
    if mask is not None:
        v_ref, i_ref, v_got, i_got = (t[mask] for t in (v_ref, i_ref, v_got, i_got))
    v_ref, v_got = v_ref.double(), v_got.double()
    fin = torch.isfinite(v_ref)
    same_inf = bool(((~fin) == ~torch.isfinite(v_got)).all()
                    and (v_ref[~fin] == v_got[~fin]).all())
    err = (v_ref[fin] - v_got[fin]).abs()
    scale = v_ref[fin].abs()
    vals_ok = bool((err <= atol + rtol * scale).all()) if fin.any() else True
    diff_id = (i_ref != i_got) & fin
    tie = (v_ref - v_got).abs() <= atol + tie_rtol * v_ref.abs()
    unexplained = int((diff_id & ~tie).sum())
    n = max(1, int(fin.sum()))
    return {
        "ok": (same_inf and vals_ok and unexplained == 0
               and int(diff_id.sum()) <= max_mismatch * n),
        "same_inf": same_inf,
        "values_ok": vals_ok,
        "max_abs_err": float(err.max()) if err.numel() else 0.0,
        "max_rel_err": float((err / scale.clamp(min=1e-30)).max())
        if err.numel() else 0.0,
        "id_mismatch_frac": int(diff_id.sum()) / n,
        "unexplained_id_mismatches": unexplained,
        "compared": int(fin.sum()),
    }
