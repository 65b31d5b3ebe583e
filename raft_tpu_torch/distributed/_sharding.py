"""Shared shard preparation, scan and merge of the distributed indexes
(counterpart of ``raft_tpu/distributed/_sharding.py``).

One implementation of the row sharding, the assign + spill phase, the
padded list size, the query-tiled shard scan, the cross-shard merge and the
degraded-mode dispatch gate (:func:`probe_shards` + :class:`SearchResult`).

Each JAX ``shard_map`` body is split at its collectives: a per-shard phase
runs for every shard this process holds (``Comms.map``), and the
collectives of :mod:`raft_tpu_torch.comms.comms` combine the per-shard
results. Nothing here branches on the transport.

The shard scan follows the port's device rule, not the JAX package's
off-TPU switch: on a CUDA shard the strip engine runs (kernel K1, or K2
for ``scan="bq"``) wherever ``strip_eligible`` holds, the dense scan only
where the JAX package's TPU path runs it too (lists too short for the
strip engine); on a CPU shard the dense scan runs, as the JAX package runs
it off the TPU (the parity route). The engine is the caller's ``dense``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs, resilience
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.comms import comms as C
from raft_tpu_torch.core.interruptible import (InterruptedException,
                                               check_interrupt)
from raft_tpu_torch.neighbors import _packing
from raft_tpu_torch.ops import bq_scan
from raft_tpu_torch.ops import strip_scan as ss
from raft_tpu_torch.ops.select_k import select_candidates, select_k
from raft_tpu_torch.resilience.retry import record_event


# ---------------------------------------------------------------------------
# Degraded-mode dispatch: shard probe, coverage accounting, result carrier
# ---------------------------------------------------------------------------


class SearchResult(tuple):
    """A ``(distances, indices)`` pair with availability metadata: it
    unpacks like the plain 2-tuple (``vals, ids = search(...)``), and
    carries ``coverage`` (the share of index rows held by the shards whose
    candidates entered the merge; 1.0 when healthy), ``degraded`` (some
    shard's candidates were dropped) and ``lost_shards`` (their ranks)."""

    def __new__(cls, distances, indices, coverage: float = 1.0,
                degraded: bool = False, lost_shards: Tuple[int, ...] = ()):
        self = tuple.__new__(cls, (distances, indices))
        self.coverage = float(coverage)
        self.degraded = bool(degraded)
        self.lost_shards = tuple(int(s) for s in lost_shards)
        return self

    @property
    def distances(self):
        return self[0]

    @property
    def indices(self):
        return self[1]


@dataclass(frozen=True)
class ShardReport:
    """One dispatch's availability verdict (:func:`probe_shards`)."""

    ok: np.ndarray            # (world,) bool — shards serving this dispatch
    coverage: float           # share of rows the serving shards hold
    degraded: bool
    dropped: Tuple[int, ...]  # shard ranks left out of this dispatch


def shard_rows_held(world: int, n_total: int) -> List[int]:
    """Real (unpadded) rows of each shard under the one row partition of
    every distributed index: ``ceil(n / world)`` contiguous rows a shard,
    the short tail on the last."""
    rows_per = -(-int(n_total) // int(world))
    return [max(0, min(rows_per, int(n_total) - r * rows_per))
            for r in range(int(world))]


def probe_shards(algo: str, world: int, n_total: int,
                 health: Optional[resilience.ShardHealth] = None,
                 phase: str = "search") -> ShardReport:
    """Host-side per-shard dispatch gate.

    For every shard not already LOST, fires the
    ``distributed.<algo>.<phase>.shard`` faultpoint (the injectable stand-in
    for a dead host) and folds the verdict into the health registry: a
    failing shard is dropped from this dispatch and marked SUSPECT / LOST
    for the next. An active hard deadline is sliced evenly over the shards
    still to probe, so a hanging shard costs its slice, not the query; an
    expired outer budget still propagates. Raises
    :class:`~raft_tpu_torch.resilience.ShardQuorumError` when the surviving
    coverage falls below the registry's quorum."""
    health = health or resilience.shard_health()
    site = f"distributed.{algo}.{phase}.shard"
    world = int(world)
    rows = shard_rows_held(world, n_total)
    dl = resilience.active_deadline()
    ok = []
    enabled = obs.enabled()
    # per-shard wall times (telemetry on only): a failing shard's probe
    # pays exception handling where a healthy one pays a bare faultpoint
    # check, so max/median spikes exactly when a shard drags
    shard_times = [] if enabled else None
    probe_span = obs.record_span("distributed::shard_probe",
                                 attrs=({"shard": world} if enabled else None))
    with probe_span:
        for r in range(world):
            if health.state(r) == resilience.LOST:
                ok.append(False)
                continue
            t_shard = time.perf_counter() if enabled else 0.0
            try:
                if dl is not None and dl.hard:
                    left = sum(1 for rr in range(r, world)
                               if health.state(rr) != resilience.LOST)
                    slice_s = max(dl.remaining(), 0.0) / max(1, left)
                    with resilience.Deadline(slice_s, hard=True,
                                             label=f"{site}[{r}]"):
                        resilience.faultpoint(site)
                else:
                    resilience.faultpoint(site)
                health.report_success(r)
                ok.append(True)
            except InterruptedException:
                raise  # a cross-thread cancel kills the query, not a shard
            except Exception as e:
                kind = resilience.classify(e)
                if kind == resilience.DEADLINE and (
                        dl is None or (dl.hard and dl.reached())):
                    # the query's budget is spent: propagate, blame no shard
                    raise
                health.report_failure(r, e)
                ok.append(False)
            if enabled:
                shard_times.append(time.perf_counter() - t_shard)
        if enabled and shard_times:
            ordered = sorted(shard_times)
            med = ordered[len(ordered) // 2]
            skew = round(max(shard_times) / max(med, 1e-9), 3)
            obs.set_gauge("distributed.shard_skew", skew)
            probe_span.set_attr("skew", skew)
    ok_np = np.asarray(ok, dtype=bool)
    covered = sum(rows[r] for r in range(world) if ok_np[r])
    coverage = covered / max(1, int(n_total))
    dropped = tuple(int(r) for r in range(world) if not ok_np[r])
    degraded = bool(dropped)
    if degraded:
        health.check_quorum(coverage, context=site)
        obs.add("distributed.partial_merge")
        record_event("partial_merge", site=site, coverage=round(coverage, 4),
                     dropped=list(dropped))
    return ShardReport(ok_np, coverage, degraded, dropped)


def blank_dead(comms: C.Comms, report: ShardReport, vals, ids,
               bad: float = float("inf")):
    """Each local shard's candidates, with a dead shard's blanked to
    (bad, -1) before the merge: the partial merge is then exact over the
    survivors."""
    out_v, out_i = [], []
    for r, v, i in zip(comms.ranks, vals, ids):
        if report.ok[r]:
            out_v.append(v)
            out_i.append(i)
        else:
            out_v.append(torch.full_like(v, bad))
            out_i.append(torch.full_like(i, -1))
    return out_v, out_i


# ---------------------------------------------------------------------------
# Build phases
# ---------------------------------------------------------------------------


def shard_rows(work, comms: C.Comms):
    """Pad rows to a multiple of the communicator size and give each local
    shard its block → (rows per shard, global ids per shard (-1 at
    padding), rows_per)."""
    work = torch.as_tensor(work)
    n = work.shape[0]
    world = comms.size
    rows_per = -(-n // world)
    parts, gids = [], []
    for r, dev in zip(comms.ranks, comms.devices):
        lo, hi = r * rows_per, min((r + 1) * rows_per, n)
        block = work[lo:hi].to(dev)
        if hi - lo < rows_per:
            block = torch.cat([block, torch.zeros(
                (rows_per - max(hi - lo, 0),) + tuple(work.shape[1:]),
                dtype=work.dtype, device=dev)], dim=0)
        g = torch.arange(r * rows_per, (r + 1) * rows_per, dtype=torch.int32,
                         device=dev)
        parts.append(block)
        gids.append(torch.where(g < n, g, torch.full_like(g, -1)))
    return parts, gids, rows_per


def assign_phase(work_parts, gids_parts, centers, km_metric: str, cap: int,
                 n_lists: int, comms: C.Comms, workspace_bytes: int = 1 << 30):
    """Assign + spill per shard → (labels per shard, counts (world,
    n_lists) numpy). Labels carry the sentinel ``n_lists`` at padded rows
    (dropped at pack); counts count real rows only. The spill runs over
    every local row, padding included, so its bookkeeping matches the
    labels; the padded zero rows are exiled to the sentinel afterwards."""

    def body(_rank, rows, ids):
        c = centers.to(rows.device)
        _, labels = kmeans_balanced._assign(rows, c, km_metric,
                                            workspace_bytes)
        if cap:
            labels = _packing.spill_to_cap(rows, c, labels, km_metric, cap)
        labels = labels.to(torch.int64)
        valid = ids >= 0
        counts = torch.bincount(labels[valid], minlength=n_lists).to(
            torch.int32)
        return (torch.where(valid, labels, torch.full_like(labels, n_lists)),
                counts)

    resilience.faultpoint("distributed.assign_phase")
    n_rows = comms.size * int(work_parts[0].shape[0])
    assign_attrs = None
    if obs.enabled():
        obs.add("distributed.assign.shards", comms.size)
        obs.add("distributed.assign.rows", n_rows)
        assign_attrs = {"shard": int(comms.size), "rows": n_rows}
    with obs.record_span("distributed::assign_phase", attrs=assign_attrs):
        out = comms.map(body, work_parts, gids_parts)
        labels = [o[0] for o in out]
        counts = C.allgather(comms, [o[1] for o in out])[0]
        counts_np = counts.cpu().numpy()
    return labels, counts_np


def round_mls(max_count: int, group: int) -> int:
    """The common padded list size: group-aligned, in power-of-two
    512-chunks when the strip granule is in play; the single-index builds'
    formula (``_packing.round_list_size``), so the two never disagree."""
    return _packing.round_list_size(max_count, group,
                                    pow2_chunks=group == 512)


def scatter_pack(labels, order_payloads, n_lists: int, mls: int):
    """Scatter rows into (n_lists, mls, ...) blocks in label order (stable:
    rows keep their order inside a list); sentinel labels (== n_lists) are
    dropped. ``order_payloads`` is a list of (init tensor, per-row values)
    pairs → one filled block per pair."""
    rp = labels.shape[0]
    dev = labels.device
    labels = labels.to(torch.int64)
    order = torch.argsort(labels, stable=True)
    sorted_labels = labels[order]
    counts = torch.bincount(torch.clamp(labels, max=n_lists),
                            minlength=n_lists + 1)
    offsets = (torch.cumsum(counts, 0) - counts)[:n_lists]
    real = sorted_labels < n_lists
    off_of = torch.where(real, offsets[torch.clamp(sorted_labels,
                                                   max=n_lists - 1)], 0)
    pos = torch.arange(rp, device=dev) - off_of
    keep = real & (pos < mls)
    outs = []
    for init, values in order_payloads:
        out = init.clone()
        out[sorted_labels[keep], pos[keep]] = values[order][keep].to(
            out.dtype)
        outs.append(out)
    return outs


# ---------------------------------------------------------------------------
# Cross-shard merge
# ---------------------------------------------------------------------------


def merge_shards(comms: C.Comms, vals, ids, k: int,
                 select_min: bool = True):
    """Cross-shard candidate exchange + exact re-select (knn_merge_parts,
    neighbors/detail/knn_merge_parts.cuh:140) over per-shard (q, k)
    candidates → per-shard (vals, ids) lists, every shard holding the same
    merged result.

    For power-of-two worlds a recursive-doubling butterfly: log2(world)
    rounds of a pairwise ``sendrecv`` and a 2k → k re-select of [mine,
    theirs] (k·log2(world) candidate rows a link instead of the
    all-gather's k·world). The butterfly's order fixes the tie order, so
    the result is the JAX package's bit for bit. Other sizes all-gather
    and re-select once."""
    bad = float("inf") if select_min else float("-inf")
    world = comms.size

    def reselect(cat_v, cat_i):
        key = torch.where(cat_i >= 0, cat_v, torch.full_like(cat_v, bad))
        v, sel = select_k(key, k, select_min=select_min)
        return v, torch.gather(cat_i, 1, sel.to(torch.int64))

    vals, ids = list(vals), list(ids)
    if world > 1 and (world & (world - 1)) == 0:
        step = 1
        while step < world:
            perm = [(i, i ^ step) for i in range(world)]
            ov = C.sendrecv(comms, vals, perm)
            oi = C.sendrecv(comms, ids, perm)
            merged = [reselect(torch.cat([v, o], 1), torch.cat([i, p], 1))
                      for v, o, i, p in zip(vals, ov, ids, oi)]
            vals = [m[0] for m in merged]
            ids = [m[1] for m in merged]
            step <<= 1
    else:
        all_v = C.allgather(comms, vals, tiled=True, gather_axis=1)
        all_i = C.allgather(comms, ids, tiled=True, gather_axis=1)
        merged = [reselect(v, i) for v, i in zip(all_v, all_i)]
        vals = [m[0] for m in merged]
        ids = [m[1] for m in merged]
    vals = [torch.where(i >= 0, v, torch.full_like(v, bad))
            for v, i in zip(vals, ids)]
    return vals, ids


# ---------------------------------------------------------------------------
# Query-tiled shard scan
# ---------------------------------------------------------------------------


def dense_local_scan(queries, probes, ld, bias, li, k: int, alpha: float,
                     pair_const=None):
    """The dense shard scan: for short lists (max_list_size not a
    power-of-two multiple of 512) and on CPU shards. One probe at a time,
    so one probe's (q, mls, dim) gather is the peak intermediate → top-k
    (vals (q, k), ids (q, k); +inf / -1 past the candidates)."""
    q = queries.shape[0]
    qf = queries.to(torch.float32)
    p = probes.shape[1]
    d_all, ids_all = [], []
    for j in range(p):
        lids = probes[:, j].to(torch.int64)
        cand = ld[lids].to(torch.float32)                     # (q, mls, d)
        d = alpha * torch.bmm(cand, qf[:, :, None])[:, :, 0] + bias[lids]
        if pair_const is not None:
            d = d + pair_const[:, j, None]
        d_all.append(d)
        ids_all.append(li[lids])
    return select_candidates(torch.cat(d_all, 1), torch.cat(ids_all, 1), k)


def _scan_shard(queries, probes, pair_const, plan, data, ids_arr, bias,
                scale, k: int, kf: int, alpha: float, dense: bool, scan: str):
    """One shard's scan of one query tile (the body of the JAX package's
    ``make_tile_fn`` up to the merge)."""
    if dense:
        if scan == "bq":
            return bq_scan.bq_dense_scan(queries, probes, data, scale, bias,
                                         ids_arr, k, alpha, pair_const)
        return dense_local_scan(queries, probes, data, bias, ids_arr, k,
                                alpha, pair_const)
    qids, strip_list, pair_strip, pair_slot, layout = plan
    if scan == "bq":
        return bq_scan._bq_tile_body(
            queries, qids, strip_list, pair_strip, pair_slot, data, scale,
            bias, ids_arr, layout, k, kf, alpha, pair_const, approx_ok=True)
    return ss._strip_tile_body(
        queries, qids, strip_list, pair_strip, pair_slot, ids_arr, layout, k,
        kf, ss._k1_class_fn(data, bias, float(alpha), kf, False), pair_const)


def tiled_search(queries_mat, probes, lens_max, n_lists: int, k: int,
                 comms: C.Comms, alpha: float, dense: bool, data: Sequence,
                 ids_arr: Sequence, bias: Sequence, pair_const=None,
                 algo: str = "ivf", n_total: int = 0, health=None,
                 scale: Optional[Sequence] = None, scan: str = "strip",
                 workspace_bytes: int = 1 << 30):
    """The query-tiled shard search of the distributed IVF indexes →
    ``(vals, ids, report)`` on the first local shard's device.

    ``data`` / ``ids_arr`` / ``bias`` (and ``scale`` for ``scan="bq"``, the
    per-entry correction factor) hold one tensor per local shard. Every
    shard runs the same plan, made once per tile from the probes and the
    per-list maximum fill across shards (``lens_max``). The dispatch
    passes :func:`probe_shards` first: a dead shard costs coverage (its
    candidates are blanked before every tile's merge), not the query.
    ``dense`` picks the dense scan over the strip engine (module
    docstring)."""
    if not dense and k > ss.MC:
        raise ValueError(f"distributed strip search supports k <= {ss.MC}, "
                         f"got {k}")
    if n_total <= 0:
        raise ValueError("tiled_search needs the true row count (n_total) "
                         "for coverage accounting")
    report = probe_shards(algo, comms.size, n_total, health=health)
    kf = min(int(k), ss.MC)
    dev0 = comms.devices[0]
    queries_mat = queries_mat.to(dev0)
    probes = probes.to(dev0)
    q, p = probes.shape
    if pair_const is None:
        pair_const = torch.zeros((q, p), dtype=torch.float32, device=dev0)
    dim = queries_mat.shape[1]
    classes, cls_ord_np = ss.class_info(np.asarray(lens_max), dim=dim)
    cls_ord = torch.as_tensor(cls_ord_np, device=dev0)
    q_tile = ss.fit_q_tile(q, p, n_lists, len(classes), kf, workspace_bytes,
                           dim=dim)
    if scale is None:
        scale = [None] * len(data)
    search_attrs = None
    if obs.enabled():
        from raft_tpu_torch.obs import tracing as obs_tracing

        search_attrs = {"shard": int(comms.size), "queries": int(q),
                        "probes": int(q * p),
                        "coverage": round(report.coverage, 4),
                        # every SPMD process stamps the same id on this
                        # dispatch: the stitcher joins their tracks on it
                        "fleet_trace_id": obs_tracing.fleet_trace_id(
                            "distributed.tiled_search")}
    out_v, out_i = [], []
    n_tiles = 0
    span = obs.record_span("distributed::tiled_search", attrs=search_attrs)
    with span:
        for start in range(0, q, q_tile):
            check_interrupt()  # cancel / hard deadline land between tiles
            resilience.faultpoint("distributed.tiled_search.tile")
            qt = min(q_tile, q - start)
            with obs.record_span("distributed::search_tile",
                                 attrs=({"tile": n_tiles, "rows": int(qt)}
                                        if obs.enabled() else None)):
                plan = None if dense else ss.plan_tile(
                    probes, start, qt, cls_ord, classes, n_lists)
                qs = queries_mat[start:start + qt]
                pr = probes[start:start + qt]
                pc = pair_const[start:start + qt]

                def body(_rank, d, i, b, sc):
                    dev = d.device
                    pl = plan if plan is None or dev == dev0 else tuple(
                        t.to(dev) if isinstance(t, torch.Tensor) else t
                        for t in plan)
                    return _scan_shard(qs.to(dev), pr.to(dev), pc.to(dev), pl,
                                       d, i, b, sc, int(k), kf, alpha, dense,
                                       scan)

                res = comms.map(body, data, ids_arr, bias, scale)
                vals, ids = blank_dead(comms, report, [r[0] for r in res],
                                       [r[1] for r in res])
                mv, mi = merge_shards(comms, vals, ids, int(k))
            out_v.append(mv[0].to(dev0))
            out_i.append(mi[0].to(dev0))
            n_tiles += 1
        span.set_attr("tiles", n_tiles)
    if obs.enabled():
        obs.add("distributed.search.shards", comms.size)
        obs.add("distributed.search.queries", q)
        obs.add("distributed.search.probes", q * p)
        obs.add("distributed.search.tiles", n_tiles)
    vals = out_v[0] if len(out_v) == 1 else torch.cat(out_v, 0)
    ids = out_i[0] if len(out_i) == 1 else torch.cat(out_i, 0)
    return vals, ids, report


def _search_engine_dense(comms: C.Comms, max_list_size: int) -> bool:
    """The scan engine of a distributed IVF search (module docstring):
    dense on CPU shards and for lists the strip engine cannot take. A mesh
    holds one device type (``Mesh`` raises otherwise), so its first shard
    speaks for all."""
    on_cuda = comms.devices[0].type == "cuda"
    return not on_cuda or not ss.strip_eligible(int(max_list_size))
