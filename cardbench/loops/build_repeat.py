"""Repeated index builds: the window runs ``ivf_pq.build`` over the rows
again and again, each synchronised before the next starts. The builds
cycle through ``build_seeds`` index seeds (``IvfPqParams.seed``, from the
configuration's data seed, the same in every run) in an order the run's
seed draws, each cycle shuffled anew: k-means stops after a number of
iterations that hangs on the index seed, so every run builds the same mix. After the
window the last index answers the query pool through the configuration's
search and refine, and those answers are judged.

Traffic keys (:data:`KEYS`; any other is an error): ``build_seeds``,
``batch`` and ``pool_batches`` (the queries, drawn from the run's seed,
that judge the last index). Set-up draws the rows and queries on the card and runs one
build and one search of the first batch (which builds the kernels on a
checkout's first run). A traced window turns on the port's spans in sync
mode (``obs.enable`` and ``obs.enable_sync``), so each build phase's span
holds its committed time."""

from __future__ import annotations

import contextlib
import random
import time

import torch

from cardbench.harness import derive, log
from cardbench.reference.judge import judge_search
from cardbench.trace import Profile, Trace
from cardbench.window import Failures, group_answers

KEYS = ("build_seeds", "batch", "pool_batches")


def run(r) -> dict:
    from raft_tpu_torch import Resources, obs
    from raft_tpu_torch.neighbors import ivf_pq, refine

    cfg, tr, dev = r.config, r.traffic_keys(KEYS), r.device
    cuda = dev.type == "cuda"
    sp = cfg["search"]
    k = int(sp["k"])
    batch, n_pool = int(tr["batch"]), int(tr["pool_batches"])
    obs.disable()
    rows, queries = r.data(n_pool * batch)
    pool = [queries[i * batch:(i + 1) * batch] for i in range(n_pool)]
    res = Resources(device=dev)

    def build(j):
        idx = ivf_pq.build(rows, ivf_pq.IvfPqParams(
            metric=cfg["metric"], seed=derive(cfg["data"]["seed"], "build", j),
            **cfg["index"]), res=res)
        if cuda:
            torch.cuda.synchronize(dev)
        return idx

    def answer(idx, qb):
        _, cand = ivf_pq.search(idx, qb, int(sp["k_fetch"]),
                                n_probes=int(sp["n_probes"]),
                                backend=sp["backend"], res=res)
        return refine.refine(rows, qb, cand, k, metric=cfg["metric"], res=res)

    index = build(-1)   # a seed the window never builds with
    answer(index, pool[0])[1].cpu()
    index = None

    trace = Trace() if r.trace else None
    if r.trace:
        obs.enable()
        obs.enable_sync()
        obs.clear_spans()
    fails = Failures()
    cycle = list(range(int(tr["build_seeds"])))
    shuffle = random.Random(derive(r.seed, "order")).shuffle
    attempted = builds = 0
    setup_s = r.elapsed()
    with (Profile(trace, dev) if r.trace else contextlib.nullcontext()):
        t0 = time.perf_counter()
        t_end = t0 + r.seconds
        while time.perf_counter() < t_end:
            if attempted % len(cycle) == 0:
                shuffle(cycle)
            j = cycle[attempted % len(cycle)]
            attempted += 1
            index = None
            try:
                index = build(j)
            except Exception:   # a build that raises is a failed request
                fails.add(f"build {attempted}")
                continue
            builds += 1
        window_s = time.perf_counter() - t0
    if r.trace:
        trace.spans = obs.spans()
        trace.builds = builds
        obs.disable_sync()
        obs.disable()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    answers, sample = [], []
    if index is not None:
        for b, qb in enumerate(pool):
            d, ids = answer(index, qb)
            answers.append((b, ids.cpu().numpy()))
            sample.append((b, d, ids))
    del index
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, recall = judge_search(rows, pool, k, group_answers(answers),
                                  sample, r.limits(), builds)
    log(f"reference {time.perf_counter() - t_ref:.3f} s; window {window_s:.3f}"
        f" s, {builds} builds, setup {setup_s:.3f} s")
    e2e = {"build_s": window_s / max(builds, 1),
           "recall_at_10": recall, "setup_s": setup_s}
    return {"attempted": attempted, "failed": fails.count, "e2e": e2e,
            "checks": checks, "memory_peak_bytes": peak, "trace": trace}
