"""The port's own spans and counters over a benchmark cell's search window,
beside the same window with telemetry off.

    python3 scripts/search_spans.py --workload sift1m-ivfpq.b10k \\
        --seed 1234567 --seconds 10 [--out chiprun_out/spans.json]

Runs on the card (``--device``, default ``cuda:0``; ``cpu`` with
``--root`` at a cut-down copy of the benchmark rehearses it), for one search cell of
``BENCHMARK.json`` (a traffic mix whose loop is ``search_closed``). It
builds the cell's index and query pool as ``cardbench/loops/
search_closed.py`` does (the same seeds), warms every batch, then runs the
closed loop (search, refine, ids to the host) in these windows:

* ``off`` / ``on``, twice each, alternating: telemetry off, then on
  (``obs.enable``, registry and span ring cleared, a ring that holds every
  span) — the rate each gives, untraced;
* ``ledger``: telemetry off, with the compile ledger's ``trace_event`` and
  ``watch`` timed per search;
* ``traced_off`` / ``traced_on``: under ``torch.profiler`` with CUDA
  events around the search and the refine, as the benchmark's traced run
  (``cardbench/trace.py``), telemetry off, then on.

From ``traced_on`` it reduces the port's span device times (per-name
totals of the registry) and counters with ``cardbench/spans.py``: the
device ms a request spends in each phase of ``ivf_pq.search``, their
coverage of the CUDA-event search time, K1's useful share, the slots'
live share, the host ms inside ``ivf_pq::search``, the device idle by the
innermost port span open at each gap, the device work by the innermost
port span open when it was issued (``work_by_issuing_span_s``: a span's
own work beside its device interval), and the clock check. Last, one warm
search under ``torch.cuda.set_sync_debug_mode("warn")`` with telemetry off
and on. Prints one JSON line (and writes it to ``--out``). Imports neither
JAX nor the JAX package.

The script stands in for the traced branch of
``cardbench/loops/search_closed.py`` until that branch reads the port's
spans; it goes when the branch does.
"""

from __future__ import annotations

import argparse
import json
import random
import statistics
import sys
import time
import warnings
from collections import defaultdict
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

RING_CAP = 1 << 21


def count_syncs(fn) -> int:
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchronizing" in str(w.message) for w in caught)


def span_site_ns(on: bool, n: int = 100_000) -> float:
    """Host nanoseconds of one span site, entered and left: with telemetry
    off the call and its branch; on, the whole span (profiler range, two
    device marks, records)."""
    from raft_tpu_torch import obs

    (obs.enable if on else obs.disable)()
    obs.reset()
    t = time.perf_counter()
    for _ in range(n):
        with obs.record_span("x::y"):
            pass
    ns = (time.perf_counter() - t) / n * 1e9
    obs.disable()
    obs.reset()
    obs.clear_spans()
    return ns


#: the host activities that issue device work, by the profiler's names;
#: where the events carry no activity type, the calls' name prefixes
ISSUING = ("cuda_runtime", "cuda_driver")
ISSUING_NAMES = ("cuda", "cuLaunch", "cuMem")


def work_by_issuing_span(events, records) -> dict:
    """Device work seconds (kernels, copies, fills) by the innermost port
    span open on the host when the runtime call that issued the work ran
    (matched by correlation id), the rest under ``spans.OUTSIDE``: how
    much of each span's device interval (``device_s``) is its own work.
    The records' ``t0``/``dur_s`` (epoch s) and the events (epoch ns) are
    on one clock. Where the events carry no activity type, the runtime
    calls are told by name (:data:`ISSUING_NAMES`) and the device's copies
    of host ranges from its work by name, as
    ``cardbench.spans.events_by_kind`` does."""
    from cardbench import spans
    from cardbench.trace import DEVICE_WORK, _interval, _is_device

    issued, work, host_names, typed = {}, [], set(), None
    for ev in events:
        if typed is None:
            typed = hasattr(ev, "activity_type")
        if _is_device(ev):
            if not typed or ev.activity_type() in DEVICE_WORK:
                s, e = _interval(ev)
                work.append((ev.correlation_id(), e - s, ev.name()))
        elif (ev.activity_type() in ISSUING if typed
              else ev.name().startswith(ISSUING_NAMES)):
            issued[ev.correlation_id()] = ev.start_ns()
        elif not typed:
            host_names.add(ev.name())
    work = [(c, ns) for c, ns, name in work if name not in host_names]
    opened = sorted((int(r["t0"] * 1e9), int((r["t0"] + r["dur_s"]) * 1e9),
                     r["name"]) for r in records)
    out = defaultdict(float)
    active, i = [], 0
    for t, ns in sorted((issued[c], ns) for c, ns in work if c in issued):
        while i < len(opened) and opened[i][0] <= t:
            active.append(opened[i])
            i += 1
        active = [o for o in active if o[1] >= t]
        out[max(active)[2] if active else spans.OUTSIDE] += ns * 1e-9
    out["unmatched"] = sum(ns for c, ns in work if c not in issued) * 1e-9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out", default=None)
    p.add_argument("--root", default=str(ROOT),
                   help="checkout whose BENCHMARK.json and cardbench/ "
                        "define the cell")
    p.add_argument("--device", default="cuda:0")
    a = p.parse_args(argv)

    import torch

    from cardbench import spans
    from cardbench.harness import Run, derive, load_cell, load_module, log
    from cardbench.trace import LayerClock, Profile, Trace
    from raft_tpu_torch import Resources, obs
    from raft_tpu_torch.core.bitset import Bitset
    from raft_tpu_torch.neighbors import ivf_pq, refine
    from raft_tpu_torch.obs import compile as obs_compile
    from raft_tpu_torch.obs import tracing
    from raft_tpu_torch.obs.registry import settle

    root = Path(a.root)
    cell = load_cell(root, a.workload)
    dev = torch.device(a.device)
    cuda = dev.type == "cuda"
    r = Run(cell, a.seed, a.seconds, True, dev, root, T_START)
    cfg, tr, sp = r.config, r.traffic, r.config["search"]
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
        **cfg["index"]), res=res)

    def search(qb):
        return ivf_pq.search(index, qb, k_fetch, n_probes=n_probes,
                             filter=bitset, backend=sp["backend"],
                             res=res)[1]

    def rerank(qb, cand):
        return refine.refine(rows, qb, cand, k, metric=cfg["metric"], res=res)

    for qb in pool:
        rerank(qb, search(qb))[1].cpu()
    order = list(range(n_pool))
    shuffle = random.Random(derive(a.seed, "order")).shuffle

    def telemetry(on: bool) -> None:
        """Telemetry on or off, with an empty registry and span ring either
        way: records a window leaves behind would slow the next one (the
        collector walks them)."""
        (obs.enable if on else obs.disable)()
        obs.reset()
        obs.clear_spans()
        tracing.set_ring_cap(RING_CAP)

    def window(seconds, clock=None):
        served = defaultdict(int)
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() < t0 + seconds:
            if n % n_pool == 0:
                shuffle(order)
            b = order[n % n_pool]
            n += 1
            qb = pool[b]
            m0 = clock.mark() if clock else None
            cand = search(qb)
            m1 = clock.mark() if clock else None
            ids = rerank(qb, cand)[1]
            m2 = clock.mark() if clock else None
            ids.cpu()
            if clock:
                clock.add("search", m0, m1)
                clock.add("refine", m1, m2)
            served[b] += 1
        return n, time.perf_counter() - t0, served

    out = {"workload": a.workload, "seed": a.seed, "seconds": a.seconds,
           "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "torch": torch.__version__}
    rates = {"off": [], "on": []}
    for mode in ("off", "on", "off", "on"):
        telemetry(mode == "on")
        n, w, _ = window(a.seconds)
        rates[mode].append(n * batch / w)
        log(f"{mode}: {n} requests in {w:.3f} s, {n * batch / w:.1f} qps")
    out["qps_off"] = rates["off"]
    out["qps_on"] = rates["on"]
    out["on_cost"] = 1.0 - statistics.mean(rates["on"]) / statistics.mean(
        rates["off"])

    # the compile ledger's share of a search with telemetry off
    telemetry(False)
    spent = {"trace_event": 0.0, "watch": 0.0}
    real_event, real_watch = obs_compile.trace_event, obs_compile.watch

    def timed_event(*args, **kw):
        t = time.perf_counter()
        try:
            return real_event(*args, **kw)
        finally:
            spent["trace_event"] += time.perf_counter() - t

    class TimedWatch:
        def __enter__(self):
            t = time.perf_counter()
            self.w = real_watch()
            self.w.__enter__()
            spent["watch"] += time.perf_counter() - t

        def __exit__(self, *exc):
            t = time.perf_counter()
            try:
                return self.w.__exit__(*exc)
            finally:
                spent["watch"] += time.perf_counter() - t

    obs_compile.trace_event, obs_compile.watch = timed_event, TimedWatch
    try:
        n, _, _ = window(min(a.seconds, 5.0))
    finally:
        obs_compile.trace_event, obs_compile.watch = real_event, real_watch
    out["ledger_us_per_search"] = {k_: 1e6 * v / n for k_, v in spent.items()}
    out["span_site_off_ns"] = span_site_ns(False)
    out["span_site_on_ns"] = span_site_ns(True)

    k1_reader = load_module(root / "cardbench" / "metrics" / "k1_roofline.py",
                            "metric_k1_roofline")
    loop = load_module(root / "cardbench" / "loops" / "search_closed.py",
                       "loop_search_closed")
    for mode in ("traced_off", "traced_on"):
        on = mode == "traced_on"
        telemetry(on)
        trace, clock = Trace(), LayerClock(dev)
        with Profile(trace, dev) as prof:
            n, w, served = window(a.seconds, clock)
        ms = clock.ms()
        trace.layer_ms = ms
        trace.work["k1"] = loop.scan_work(r, index, pool, served, mask)
        row = {"requests": n, "qps": n * batch / w,
               "search_ms": statistics.mean(ms["search"]),
               "refine_ms": statistics.mean(ms["refine"]),
               "idle_share": trace.idle_share,
               "k1_roofline": k1_reader.read(trace),
               "k1_device_ms": 1e3 * sum(
                   s for name, s in trace.device_ops.items()
                   if k1_reader.is_k1(name)) / n,
               "busy_s": trace.busy_s, "window_s": trace.window_s,
               "idle_by_host_s": dict(sorted(
                   trace.idle_by_host.items(), key=lambda kv: -kv[1])[:8])}
        if on:
            t = time.perf_counter()
            records = obs.spans()
            settle()
            snap = obs.snapshot()
            row["settle_s"] = time.perf_counter() - t
            devw, win, ranges = spans.events_by_kind(
                prof.prof.profiler.kineto_results.events())
            row["spans"] = len(records)
            row.update(spans.reduce_spans(snap, records, row["search_ms"],
                                          devw, win))
            row["work_by_issuing_span_s"] = work_by_issuing_span(
                prof.prof.profiler.kineto_results.events(), records)
            row["clock"] = spans.clock_check(records, ranges)
        out[mode] = row
        log(f"{mode}: {json.dumps(row)[:2000]}")
    telemetry(False)

    if cuda:
        qb = pool[0]
        out["syncs_off"] = count_syncs(lambda: search(qb))
        telemetry(True)
        search(qb)
        out["syncs_on"] = count_syncs(lambda: search(qb))
        telemetry(False)
    line = json.dumps(out)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
