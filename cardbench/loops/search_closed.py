"""Closed-loop batched search: one client sends a batch of queries, waits
until its ids are on the host, then sends the next.

Traffic keys (:data:`KEYS`; any other is an error): ``clients`` (1, the
default: the loop drives one client and raises for more), ``batch``
(queries a request), ``pool_batches`` (batches drawn in set-up from the
run's seed and cycled through in an order drawn from it, each cycle
shuffled anew), ``check_sample`` (answers of the window kept, drawn from
the seed, for the distance comparison), optionally ``filter_pass`` (one
filter passing that share of the rows, drawn from the seed) and
``limits`` (the traffic's own limits of the comparison).

A request is ``ivf_pq.search`` at the configuration's ``k_fetch`` and
``n_probes``, then ``refine.refine`` to ``k``, then the ids to the host.
Set-up draws the rows and queries on the card, builds the index (its seed
the configuration's data seed: one deployment, one index) and runs every
batch of the pool once (which builds the kernels on a checkout's
first run and fills the index's int8 cache)."""

from __future__ import annotations

import contextlib
import random
import time

import torch

from cardbench.harness import derive, log
from cardbench.reference.judge import judge_search
from cardbench.roofline import ivf_scan
from cardbench.roofline.peaks import least_seconds, peaks
from cardbench.trace import LayerClock, Profile, Trace
from cardbench.window import (Failures, Reservoir, group_answers, labeller,
                              p95)

KEYS = ("clients", "batch", "pool_batches", "check_sample", "filter_pass",
        "limits")


def scan_work(r, index, pool, served, mask) -> dict:
    """The yardstick's least time of the window's list scans
    (``cardbench/roofline/ivf_scan``), summed over the requests served."""
    cfg, sp = r.config, r.config["search"]
    dim, pq_dim = int(cfg["data"]["dim"]), int(cfg["index"]["pq_dim"])
    rot_dim = pq_dim * -(-dim // pq_dim)
    list_ids = index.list_ids
    live = list_ids >= 0
    pass_rate = None
    if mask is not None:
        live &= mask[list_ids.clamp(min=0).to(torch.int64)]
        pass_rate = float(mask.float().mean())
    live_rows = live.sum(1).to(torch.int64)
    n_lists = int(live_rows.shape[0])
    n_probes = ivf_scan.widened(int(sp["n_probes"]), n_lists, pass_rate)
    pk = peaks(torch.cuda.get_device_name(r.device)) \
        if r.device.type == "cuda" else None
    if pk is None:
        return {}
    least, by_bytes = 0.0, 0.0
    for b, count in served.items():
        w = ivf_scan.work(ivf_scan.probes(pool[b], index.centers, n_probes),
                          live_rows, rot_dim, int(sp["k_fetch"]))
        s, by = least_seconds(w["flops"], w["bytes"], pk)
        least += count * s
        by_bytes += count * s * (by == "bytes")
    bound_by = "bytes" if by_bytes >= least / 2 else "operations"
    log(f"k1 yardstick: n_probes {n_probes}, least {least:.6f} s over the "
        f"window, bound by {bound_by}")
    return {"least_s": least, "bound_by": bound_by}


def run(r) -> dict:
    from raft_tpu_torch import Resources, obs
    from raft_tpu_torch.core.bitset import Bitset
    from raft_tpu_torch.neighbors import ivf_pq, refine

    cfg, tr, dev = r.config, r.traffic_keys(KEYS), r.device
    if int(tr.get("clients", 1)) != 1:
        raise ValueError(f"search_closed drives one client, not "
                         f"{tr['clients']}")
    cuda = dev.type == "cuda"
    sp = cfg["search"]
    k, k_fetch, n_probes = int(sp["k"]), int(sp["k_fetch"]), int(sp["n_probes"])
    batch, n_pool = int(tr["batch"]), int(tr["pool_batches"])
    obs.disable()
    rows, queries = r.data(n_pool * batch)
    pool = [queries[i * batch:(i + 1) * batch] for i in range(n_pool)]
    mask = r.filter_mask(rows.shape[0])
    bitset = None if mask is None else Bitset.from_mask(mask, device=dev)
    res = Resources(device=dev)
    index = ivf_pq.build(rows, ivf_pq.IvfPqParams(
        metric=cfg["metric"], seed=derive(cfg["data"]["seed"], "index"),
        **cfg["index"]),
        res=res)

    def search(qb, stats=None):
        _, cand = ivf_pq.search(index, qb, k_fetch, n_probes=n_probes,
                                filter=bitset, backend=sp["backend"], res=res,
                                stats=stats)
        return cand

    def rerank(qb, cand):
        return refine.refine(rows, qb, cand, k, metric=cfg["metric"], res=res)

    stats: dict = {}
    for qb in pool:
        rerank(qb, search(qb, stats))[1].cpu()
    log(f"{r.cell.name}: backend {stats.get('backend')!r}, rows "
        f"{tuple(rows.shape)} {rows.dtype}, max_list_size "
        f"{index.max_list_size}")

    trace = Trace() if r.trace else None
    clock = LayerClock(dev)
    label = labeller(r.trace)
    order = list(range(n_pool))
    shuffle = random.Random(derive(r.seed, "order")).shuffle
    sample = Reservoir(tr["check_sample"], derive(r.seed, "sample"))
    answers, served, fails = [], {}, Failures()
    attempted = 0
    setup_s = r.elapsed()
    with (Profile(trace, dev) if r.trace else contextlib.nullcontext()):
        t0 = time.perf_counter()
        t_end = t0 + r.seconds
        while time.perf_counter() < t_end:
            if attempted % n_pool == 0:
                shuffle(order)
            b = order[attempted % n_pool]
            attempted += 1
            qb = pool[b]
            try:
                m0 = clock.mark()
                with label("cardbench.search"):
                    cand = search(qb)
                m1 = clock.mark() if r.trace else None
                with label("cardbench.refine"):
                    d, ids = rerank(qb, cand)
                m2 = clock.mark() if r.trace else None
                with label("cardbench.ids_to_host"):
                    ids_h = ids.cpu().numpy()
                m3 = clock.mark()
            except Exception:   # a request that raises is a failed request
                fails.add(f"request {attempted}")
                continue
            clock.add("request", m0, m3)
            if r.trace:
                clock.add("search", m0, m1)
                clock.add("refine", m1, m2)
            answers.append((b, ids_h))
            served[b] = served.get(b, 0) + 1
            sample.offer((b, d, ids))
        window_s = time.perf_counter() - t0
    ms = clock.ms()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if trace is not None:
        trace.layer_ms = ms
        trace.work["k1"] = scan_work(r, index, pool, served, mask)
    del index, bitset
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, recall = judge_search(rows, pool, k, group_answers(answers),
                                  sample.items, r.limits(), len(answers),
                                  mask)
    log(f"reference {time.perf_counter() - t_ref:.3f} s; window {window_s:.3f}"
        f" s, {len(answers)} answers, setup {setup_s:.3f} s")
    e2e = {"qps": len(answers) * batch / window_s,
           "p95_ms": p95(ms.get("request", [])),
           "recall_at_10": recall, "setup_s": setup_s}
    return {"attempted": attempted, "failed": fails.count, "e2e": e2e,
            "checks": checks, "memory_peak_bytes": peak, "trace": trace}
