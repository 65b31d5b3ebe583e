"""Sort-based segment utilities for graph algorithms (counterpart of
``raft_tpu/ops/segment.py``).

The GPU reference scatters candidate edges into per-node lists with
atomics; the JAX package replaced that with sort-based distribution (sort
the edge list by target, locate each segment's span with ``searchsorted``,
gather a capped number per segment) and a sort-based merge with dedup. The
port keeps both as they are: they define the graph CAGRA's ``optimize``
builds, so the orders (stable sorts, lowest position first on ties) are
the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def lexsort2(secondary: torch.Tensor, primary: torch.Tensor) -> torch.Tensor:
    """Indices that sort the last axis by ``primary``, then ``secondary``,
    then position: ``jnp.lexsort((secondary, primary))``."""
    order = torch.sort(secondary, dim=-1, stable=True).indices
    prim = torch.gather(primary, -1, order)
    return torch.gather(order, -1,
                        torch.sort(prim, dim=-1, stable=True).indices)


def segment_take(keys_sorted: torch.Tensor, n_segments: int, cap: int,
                 *values: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Per-segment capped gather from a key-sorted flat array.

    ``keys_sorted`` is an ascending (m,) int tensor of segment ids (invalid
    entries sorted to the end with key ≥ ``n_segments``). For each segment
    s, the first ``cap`` positions of its span. Returns ``(valid
    (n_segments, cap) bool, *gathered values)``; entries past ``cap`` are
    dropped."""
    m = keys_sorted.shape[0]
    seg = torch.arange(n_segments, dtype=keys_sorted.dtype,
                       device=keys_sorted.device)
    starts = torch.searchsorted(keys_sorted, seg)
    pos = starts[:, None] + torch.arange(cap, device=keys_sorted.device)[None, :]
    in_range = pos < m
    posc = torch.clamp(pos, max=m - 1)
    valid = in_range & (keys_sorted[posc] == seg[:, None])
    return (valid,) + tuple(v[posc] for v in values)


def merge_topk_dedup(ids: torch.Tensor, dists: torch.Tensor,
                     cand_ids: torch.Tensor, cand_dists: torch.Tensor, k: int,
                     exclude_self: Optional[torch.Tensor] = None,
                     payload: Optional[torch.Tensor] = None,
                     cand_payload: Optional[torch.Tensor] = None):
    """Row-wise merge of (n, a) lists with (n, b) candidates, dedup by id,
    top-k → ``(ids (n, k), dists (n, k), from_cand (n, k))``. Invalid
    entries are id -1 / dist +inf; ``exclude_self`` (n,) drops each row's
    own id. One lexsort by (id, dist) puts every copy of an id next to its
    best, a stable sort by distance restores the order. With ``payload`` /
    ``cand_payload`` (shaped like ``ids`` / ``cand_ids``) the survivors'
    payload comes back as a fourth output (NN-descent's new/old flags)."""
    inf = float("inf")
    all_ids = torch.cat([ids, cand_ids], dim=1)
    all_d = torch.cat([dists, cand_dists], dim=1)
    all_c = torch.cat([torch.zeros(ids.shape, dtype=torch.bool,
                                   device=ids.device),
                       torch.ones(cand_ids.shape, dtype=torch.bool,
                                  device=ids.device)], dim=1)
    order = lexsort2(all_d, all_ids)
    sid = torch.gather(all_ids, 1, order)
    sd = torch.gather(all_d, 1, order)
    sc = torch.gather(all_c, 1, order)
    dup = torch.cat([torch.zeros((sid.shape[0], 1), dtype=torch.bool,
                                 device=sid.device),
                     sid[:, 1:] == sid[:, :-1]], dim=1)
    bad = dup | (sid < 0)
    if exclude_self is not None:
        bad = bad | (sid == exclude_self[:, None])
    sd = torch.where(bad, torch.full_like(sd, inf), sd)
    order2 = torch.sort(sd, dim=1, stable=True).indices[:, :k]
    out_ids = torch.gather(sid, 1, order2)
    out_d = torch.gather(sd, 1, order2)
    out_c = torch.gather(sc, 1, order2)
    out_ids = torch.where(torch.isinf(out_d), torch.full_like(out_ids, -1),
                          out_ids)
    out_c = out_c & ~torch.isinf(out_d)
    if payload is not None:
        all_p = torch.cat([payload, cand_payload.to(payload.dtype)], dim=1)
        out_p = torch.gather(torch.gather(all_p, 1, order), 1, order2)
        return out_ids, out_d, out_c, out_p
    return out_ids, out_d, out_c
