"""Closed-loop batched graph search: one client sends a batch of queries to
``cagra.search``, waits until its ids are on the host, then sends the next.

Traffic keys (:data:`KEYS`; any other is an error): ``clients`` (1, the
default: the loop drives one client and raises for more), ``batch``
(queries a request), ``pool_batches`` (batches drawn in set-up from the
run's seed and cycled through in an order drawn from it, each cycle
shuffled anew), ``check_sample`` (answers of the window kept, drawn from
the seed, for the distance comparison) and ``limits`` (the traffic's own
limits of the comparison).

A request is ``cagra.search`` at the configuration's ``search`` settings
(``k`` and the fields of ``CagraSearchParams``), then the ids to the host.
Set-up draws the rows and queries on the card, builds the index with
``CagraParams(seed=derive(data seed, "index"), **index)`` (one deployment,
one index) and runs every batch of the pool once, which builds the kernels
on a checkout's first run. Those searches must run as the cell means, or
set-up raises: one query tile a request, and on the card the fused
traversal, one launch of K6 a hop.

A traced window (``--trace 1``) turns the port's telemetry on and leaves in
the :class:`~cardbench.trace.Trace`:

* ``layer_ms["search"]``: CUDA events around each ``cagra.search``;
* ``spans``: one record a span name, from the registry's per-name totals
  after ``settle()`` (exact whatever the span ring holds): ``count``,
  ``dur_s`` (host seconds) and ``device_s`` (the card's seconds between
  each span's entry and exit marks; absent off the card);
* ``work["k6"]``: the port's ``cagra.*`` counters (``counters``) and the
  K6 yardstick (:mod:`cardbench.roofline.cagra_hop`) over the hops the
  searches reported in ``stats`` (``least_s``, ``bound_by``, ``hops``).
"""

from __future__ import annotations

import contextlib
import random
import time

import torch

from cardbench.harness import derive, log
from cardbench.reference.judge import judge_search
from cardbench.roofline import cagra_hop
from cardbench.roofline.peaks import least_seconds, peaks
from cardbench.trace import LayerClock, Profile, Trace
from cardbench.window import (Failures, Reservoir, group_answers, labeller,
                              p95)

KEYS = ("clients", "batch", "pool_batches", "check_sample", "limits")


def k6_work(r, index, q: int, hops: int, width: int, itopk: int) -> dict:
    """The yardstick's least time of the window's K6 hops: ``hops`` hops
    of ``q`` queries each, at the card's peaks; {} off a listed card."""
    pk = peaks(torch.cuda.get_device_name(r.device)) \
        if r.device.type == "cuda" else None
    if pk is None or index.nbr_codes is None:
        return {}
    w = cagra_hop.work(q, hops, width, index.graph_degree,
                       index.nbr_codes.shape[2], itopk)
    least, bound_by = least_seconds(w["flops"], w["bytes"], pk,
                                    cagra_hop.RATE)
    log(f"k6 yardstick: {hops} hops of {q} queries, least {least:.6f} s "
        f"over the window, bound by {bound_by}")
    return {"least_s": least, "bound_by": bound_by, "hops": hops}


def span_totals(timers: dict) -> list:
    """One record a span name from the registry's timers."""
    return [{"name": name, "count": t["count"], "dur_s": t["total_s"],
             "device_s": t.get("device_total_s")}
            for name, t in timers.items()]


def run(r) -> dict:
    from raft_tpu_torch import Resources, obs
    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.obs.registry import settle
    from raft_tpu_torch.ops.cagra_hop import HOP_KERNEL

    cfg, tr, dev = r.config, r.traffic_keys(KEYS), r.device
    if int(tr.get("clients", 1)) != 1:
        raise ValueError(f"graph_closed drives one client, not "
                         f"{tr['clients']}")
    if cfg["metric"] != "sqeuclidean":
        raise ValueError(f"cagra searches under sqeuclidean, not "
                         f"{cfg['metric']!r}")
    cuda = dev.type == "cuda"
    sp = dict(cfg["search"])
    k = int(sp.pop("k"))
    params = cagra.CagraSearchParams(**sp)
    batch, n_pool = int(tr["batch"]), int(tr["pool_batches"])
    obs.disable()
    rows, queries = r.data(n_pool * batch)
    pool = [queries[i * batch:(i + 1) * batch] for i in range(n_pool)]
    res = Resources(device=dev)
    index = cagra.build(rows, cagra.CagraParams(
        seed=derive(cfg["data"]["seed"], "index"), **cfg["index"]), res=res)
    log(f"{r.cell.name}: build {index.build_timings_s}, rows "
        f"{tuple(rows.shape)} {rows.dtype}, degree {index.graph_degree}")

    def search(qb, stats=None):
        return cagra.search(index, qb, k, params, res=res, stats=stats)

    for qb in pool:
        st: dict = {}
        before = HOP_KERNEL.launches
        search(qb, st)[1].cpu()
        launches = HOP_KERNEL.launches - before
        if st["tiles"] != 1 or (cuda and (
                st["mode"] != "fused" or launches != sum(st["hops"]))):
            raise RuntimeError(
                f"{r.cell.name}: the search did not run as one tile through "
                f"K6 once a hop: {st}, {launches} K6 launches")
    log(f"{r.cell.name}: mode {st['mode']!r}, hops {st['hops']}, q_tile "
        f"{st['q_tile']}")

    trace = Trace() if r.trace else None
    if r.trace:
        obs.reset()
        obs.clear_spans()
        obs.enable()
    clock = LayerClock(dev)
    label = labeller(r.trace)
    order = list(range(n_pool))
    shuffle = random.Random(derive(r.seed, "order")).shuffle
    sample = Reservoir(tr["check_sample"], derive(r.seed, "sample"))
    answers, fails = [], Failures()
    attempted = hops = 0
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
            st = {} if r.trace else None
            try:
                m0 = clock.mark()
                with label("cardbench.search"):
                    d, ids = search(qb, st)
                m1 = clock.mark() if r.trace else None
                with label("cardbench.ids_to_host"):
                    ids_h = ids.cpu().numpy()
                m2 = clock.mark()
            except Exception:   # a request that raises is a failed request
                fails.add(f"request {attempted}")
                continue
            clock.add("request", m0, m2)
            if r.trace:
                clock.add("search", m0, m1)
                hops += sum(st["hops"])
            answers.append((b, ids_h))
            sample.offer((b, d, ids))
        window_s = time.perf_counter() - t0
    ms = clock.ms()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if trace is not None:
        settle()
        snap = obs.snapshot()
        obs.disable()
        trace.layer_ms = ms
        trace.spans = span_totals(snap["timers"])
        counters = {name: v for name, v in snap["counters"].items()
                    if name.startswith("cagra.")}
        log(f"port counters: {counters}")
        trace.work["k6"] = {
            **k6_work(r, index, batch, hops,
                      min(params.search_width, params.itopk_size),
                      min(params.itopk_size, index.size)),
            "counters": counters}
    del index
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, recall = judge_search(rows, pool, k, group_answers(answers),
                                  sample.items, r.limits(), len(answers))
    log(f"reference {time.perf_counter() - t_ref:.3f} s; window {window_s:.3f}"
        f" s, {len(answers)} answers, setup {setup_s:.3f} s")
    e2e = {"qps": len(answers) * batch / window_s,
           "p95_ms": p95(ms.get("request", [])),
           "recall_at_10": recall, "setup_s": setup_s}
    return {"attempted": attempted, "failed": fails.count, "e2e": e2e,
            "checks": checks, "memory_peak_bytes": peak, "trace": trace}
