"""Padded-list packing for IVF indexes (counterpart of
``raft_tpu/neighbors/_packing.py``): rows are scattered into one dense
(n_lists, max_list_size, ...) block with ``list_ids == -1`` at padding."""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import torch

from raft_tpu_torch.ops.distance import matmul_t, sqnorm
from raft_tpu_torch.ops.select_k import select_k

_N_ALT = 4  # nearest-alternative rounds before the pressure valve

_log = logging.getLogger("raft_tpu_torch")

#: compile-ledger entries of the paged scans: a delta of
#: :func:`paged_trace_count` over a serving window counts the new operand
#: signatures (shapes) the scans met, and each one's ledger record names
#: the operand that changed (obs/compile.py)
PAGED_ENTRIES = ("ivf_flat.paged_scan", "ivf_pq.paged_scan",
                 "ivf_flat.paged_pallas", "ivf_pq.paged_pallas",
                 "ivf_bq.paged_pallas")


def paged_trace_count() -> int:
    """Ledger records of the paged scan entries in this process."""
    from raft_tpu_torch.obs import compile as obs_compile

    return sum(obs_compile.trace_count(e) for e in PAGED_ENTRIES)


def round_list_size(max_count: int, group_size: int,
                    pow2_chunks: bool = False) -> int:
    """Max cluster size rounded up to ``group_size`` and, with
    ``pow2_chunks``, to a power-of-two number of group_size chunks."""
    mls = max(group_size, -(-int(max_count) // group_size) * group_size)
    if pow2_chunks:
        chunks = mls // group_size
        mls = group_size * (1 << (chunks - 1).bit_length())
    return mls


def chunk_ranks(labels: torch.Tensor, n_lists: int):
    """Arrival rank of each row within its label, in label-sorted order:
    ``(order, sorted_labels, rank_sorted)``."""
    m = labels.shape[0]
    order = torch.argsort(labels, stable=True)
    sorted_labels = labels[order]
    counts = torch.bincount(labels, minlength=n_lists + 1)[:n_lists]
    offsets = torch.cumsum(counts, 0) - counts
    safe = sorted_labels.clamp(max=n_lists - 1)
    rank_sorted = torch.arange(m, device=labels.device) - offsets[safe]
    return order, sorted_labels, rank_sorted


def pack_lists(payload: torch.Tensor, row_ids: torch.Tensor,
               labels: torch.Tensor, n_lists: int, group_size: int,
               pow2_chunks: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter rows into padded per-list blocks → (list_payload, list_ids).
    Rows keep their arrival order within a list."""
    labels = labels.to(torch.int64)
    n = payload.shape[0]
    sizes = torch.bincount(labels, minlength=n_lists)
    max_size = round_list_size(int(sizes.max()), group_size, pow2_chunks)
    order = torch.argsort(labels, stable=True)
    sorted_labels = labels[order]
    offsets = torch.cumsum(sizes, 0) - sizes
    pos = torch.arange(n, device=labels.device) - offsets[sorted_labels]
    list_payload = torch.zeros((n_lists, max_size) + tuple(payload.shape[1:]),
                               dtype=payload.dtype, device=payload.device)
    list_ids = torch.full((n_lists, max_size), -1, dtype=torch.int32,
                          device=payload.device)
    list_payload[sorted_labels, pos] = payload[order]
    list_ids[sorted_labels, pos] = row_ids[order].to(torch.int32)
    return list_payload, list_ids


def spill_to_cap(work: torch.Tensor, centers: torch.Tensor,
                 labels: torch.Tensor, metric: str, cap: int,
                 base_counts: Optional[torch.Tensor] = None,
                 chunk: int = 65536) -> torch.Tensor:
    """Cap per-list occupancy: rows ranked ≥ cap in their cluster (after
    the ``base_counts`` rows each list already holds, as ``extend`` has)
    bid for their nearest alternative centers with room (4 rounds), and any
    residue is packed into free slots across all lists, emptiest first — so
    the cap is hard whenever n_lists·cap ≥ n + Σ base_counts."""
    n_lists = centers.shape[0]
    labels = labels.to(torch.int64)
    dev = labels.device
    base = (torch.zeros(n_lists, dtype=torch.int64, device=dev)
            if base_counts is None else base_counts.to(dev, torch.int64))
    counts = torch.bincount(labels, minlength=n_lists)
    if int((counts + base).max()) <= cap:
        return labels
    n = labels.shape[0]
    order = torch.argsort(labels, stable=True)
    offsets = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(n, device=dev) - offsets[labels[order]]
    rank = torch.zeros(n, dtype=torch.int64, device=dev)
    rank[order] = rank_sorted
    over = base[labels] + rank >= cap

    n_alt = min(_N_ALT, n_lists - 1)
    if n_alt <= 0:
        return labels
    alts = []
    for s in range(0, n, chunk):
        w = work[s:s + chunk]
        lb = labels[s:s + chunk]
        if metric == "inner_product":
            d = -matmul_t(w, centers, torch.bfloat16)
        else:
            d = torch.clamp(sqnorm(w)[:, None] + sqnorm(centers)[None, :]
                            - 2.0 * matmul_t(w, centers, torch.bfloat16),
                            min=0.0)
        d[torch.arange(w.shape[0], device=dev), lb] = float("inf")
        _, a = select_k(d, n_alt, select_min=True)
        alts.append(a.to(torch.int64))
    alt = torch.cat(alts) if len(alts) > 1 else alts[0]

    free = torch.clamp(cap - (base + counts), min=0)
    labels_out = labels.clone()
    remaining = over
    for r in range(n_alt):
        targets = alt[:, r]
        target = torch.where(remaining, targets, torch.full_like(targets, n_lists))
        s_order = torch.argsort(target, stable=True)
        t_sorted = target[s_order]
        t_counts = torch.bincount(t_sorted, minlength=n_lists + 1)
        t_off = torch.cumsum(t_counts, 0) - t_counts
        t_rank = torch.zeros(n, dtype=torch.int64, device=dev)
        t_rank[s_order] = torch.arange(n, device=dev) - t_off[t_sorted]
        admitted = (remaining & (t_rank < free[target.clamp(max=n_lists - 1)])
                    & (target < n_lists))
        labels_out = torch.where(admitted, targets, labels_out)
        free = free - torch.bincount(
            torch.where(admitted, targets, torch.full_like(targets, n_lists)),
            minlength=n_lists + 1)[:n_lists]
        remaining = remaining & ~admitted
    # pressure valve: the residue goes to free slots, emptiest list first
    order_lists = torch.argsort(-free, stable=True)
    cumfree = torch.cumsum(free[order_lists], 0)
    t_rank = torch.cumsum(remaining.to(torch.int64), 0) - 1
    slot = torch.searchsorted(cumfree, t_rank, right=True)
    ok = remaining & (t_rank < cumfree[-1]) & (slot < n_lists)
    labels_out = torch.where(ok, order_lists[slot.clamp(max=n_lists - 1)],
                             labels_out)
    n_res = int(ok.sum())
    if n_res:
        _log.warning("spill_to_cap: %d row(s) exhausted their %d nearest "
                     "alternative lists and went to distant free slots",
                     n_res, n_alt)
    return labels_out


def auto_group_size(n: int, n_lists: int, floor: int = 64) -> int:
    """512 (the strip granule) when the mean list is big enough that the
    padding is noise, else ``floor``."""
    return 512 if n // max(n_lists, 1) >= 192 else floor


def auto_list_cap(n: int, n_lists: int, group_size: int, factor: int = 4) -> int:
    """Default cap: ``factor`` × mean occupancy, group-aligned."""
    mean = -(-n // n_lists)
    return max(group_size, -(-(factor * mean) // group_size) * group_size)


def unpack_lists(list_payload: torch.Tensor, list_ids: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_lists`: the valid rows' (payload, ids,
    labels), list by list in slot order."""
    n_lists, max_size = list_ids.shape
    valid = list_ids.reshape(-1) >= 0
    payload = list_payload.reshape((-1,) + tuple(list_payload.shape[2:]))[valid]
    labels = torch.arange(n_lists, dtype=torch.int32,
                          device=list_ids.device).repeat_interleave(max_size)
    return payload, list_ids.reshape(-1)[valid], labels[valid]


def assign_top2(rows: torch.Tensor, centers: torch.Tensor, block: int = 4096,
                metric: str = "sqeuclidean"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best and second-best center per row (int32 each), over center blocks
    of ``block``: the streamed builds' capacity diversion spills to the
    runner-up. "sqeuclidean" ranks by ‖c‖² − 2⟨row, c⟩, "inner_product" by
    −⟨row, c⟩; ties go to the lowest index, as in the JAX package."""
    m = rows.shape[0]
    n_c = centers.shape[0]
    dev = rows.device
    inf = torch.full((m,), float("inf"), device=dev)
    zero = torch.zeros((m,), dtype=torch.int64, device=dev)
    v1, i1, v2, i2 = inf, zero, inf, zero
    lanes = torch.arange(4, device=dev)[None, :]
    for b0 in range(0, n_c, block):
        cb = centers[b0:b0 + block]
        ip = rows @ cb.T
        d = -ip if metric == "inner_product" else sqnorm(cb)[None, :] - 2.0 * ip
        bv1, ba1 = torch.min(d, dim=1)
        d2 = d.clone()
        d2[torch.arange(m, device=dev), ba1] = float("inf")
        bv2, ba2 = torch.min(d2, dim=1)
        cand_v = torch.stack([v1, v2, bv1, bv2], dim=1)
        cand_i = torch.stack([i1, i2, ba1 + b0, ba2 + b0], dim=1)
        na1 = torch.argmin(cand_v, dim=1)
        nv1 = torch.gather(cand_v, 1, na1[:, None])[:, 0]
        ni1 = torch.gather(cand_i, 1, na1[:, None])[:, 0]
        cv2 = torch.where(lanes == na1[:, None], float("inf"), cand_v)
        na2 = torch.argmin(cv2, dim=1)
        v1, i1 = nv1, ni1
        v2 = torch.gather(cv2, 1, na2[:, None])[:, 0]
        i2 = torch.gather(cand_i, 1, na2[:, None])[:, 0]
    return i1.to(torch.int32), i2.to(torch.int32)


def divert_to_cap(l1: torch.Tensor, l2: torch.Tensor,
                  run_counts: torch.Tensor, cap: int,
                  n_lists: int) -> torch.Tensor:
    """Capacity diversion for one streamed chunk: a row whose nearest list
    is full (the running fill ``run_counts`` plus its chunk-local arrival
    rank) takes its second-nearest; a row whose second choice is full too
    gets the drop sentinel ``n_lists``. int32 labels."""
    m = l1.shape[0]
    run = run_counts.to(torch.int64)

    def rank_of(lab):
        order, _, rank_sorted = chunk_ranks(lab, n_lists)
        r = torch.zeros(m, dtype=torch.int64, device=lab.device)
        r[order] = rank_sorted
        return r

    l1, l2 = l1.to(torch.int64), l2.to(torch.int64)
    full1 = run[l1] + rank_of(l1) >= cap
    lab = torch.where(full1, l2, l1)
    full2 = run[lab.clamp(max=n_lists - 1)] + rank_of(lab) >= cap
    return torch.where(full2, n_lists, lab).to(torch.int32)
