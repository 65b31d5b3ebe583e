"""Config-driven ANN benchmark runner (counterpart of
``raft_tpu/bench/runner.py``; reference raft-ann-bench: per-algorithm param
sweeps producing QPS/recall records, docs/source/raft_ann_benchmarks.md:
420-438; JSON configs like cpp/bench/ann/src/common/conf.hpp).

Usage:
    python -m raft_tpu_torch.bench.runner config.json -o results.json
    python -m raft_tpu_torch.bench.runner config.json --device cpu

Config schema (JSON / dict):
    {
      "dataset": {"kind": "blobs", "n": 100000, "dim": 64, "n_queries": 1000,
                  "n_clusters": 512, "seed": 0}
               | {"kind": "siftlike", "n": 1000000, "dim": 128,
                  "n_queries": 10000, "seed": 0}
               | {"kind": "files", "base": "base.npy", "queries": "q.npy"}
               | {"kind": "real", "name": "sift", "root": "...",
                  "max_rows": 1000000},
      "k": 10,
      "algos": [
        {"name": "brute_force", "build": {}, "search": [{}]},
        {"name": "ivf_flat", "build": {"n_lists": 256},
         "search": [{"n_probes": 8}, {"n_probes": 32}]},
        {"name": "ivf_pq", "build": {"n_lists": 256, "pq_dim": 32},
         "search": [{"n_probes": 32, "refine_ratio": 4}]},
        {"name": "cagra", "build": {"graph_degree": 32},
         "search": [{"max_iterations": 24}]}
      ]
    }

Each (algo, search-params) pair yields one record:
    {"algo", "build_params", "search_params", "build_s", "qps", "recall", "k"}
— the reference harness's Latency/QPS/Recall counters, with the JAX
package's keys and order.

Everything runs on ``cuda`` unless ``device``/``res`` (or ``--device``)
ask for the CPU; on the card each family's search runs its kernels (IVF-Flat
and IVF-PQ at strip-eligible list sizes through K1,
``ops/csrc/strip_scan.cu``; CAGRA's ``traversal="fused"`` through K6,
``ops/csrc/cagra_hop.cu``). Build time ends at a synchronisation of the
device the index lives on, and QPS batches end at a host fetch of the
results. The JAX runner's ``enable_persistent_cache()`` is XLA's
compilation cache and has no counterpart here: nothing is compiled per
shape (the kernels are built once per source by ``ops/_native``).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from raft_tpu_torch import random as rt_random
from raft_tpu_torch.stats import metrics as stats
from raft_tpu_torch.core.resources import Resources, resources_for
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq, refine


def _force(x) -> float:
    """Host fetch of a result tensor: returns once every launch producing
    ``x`` has finished."""
    return float(torch.where(torch.isfinite(x), x,
                             torch.zeros((), dtype=x.dtype,
                                         device=x.device)).sum())


def _synchronize(device: torch.device) -> None:
    """Wait for everything queued on ``device`` (the build-time barrier)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _as_f32(array, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` as fp32 (moved in its own dtype, then
    widened there)."""
    array = np.asarray(array)
    if not array.flags.writeable:      # a memory-mapped .npy slice
        array = array.copy()
    return torch.from_numpy(array).to(device).to(torch.float32)


def _load_dataset(spec: Dict, device: torch.device):
    kind = spec.get("kind", "blobs")
    if kind == "files":
        # any supported on-disk format: .npy, TEXMEX .fvecs/.bvecs,
        # big-ann .fbin/.u8bin/... (bench/io.py readers)
        from raft_tpu_torch.bench.io import read_any

        base = read_any(spec["base"], spec.get("max_rows"))
        queries = read_any(spec["queries"])
        return _as_f32(base, device), _as_f32(queries, device)
    if kind == "real":
        # resolve a standard dataset directory (TEXMEX / big-ann / hdf5);
        # errors out rather than silently benching synthetic data
        from raft_tpu_torch.bench.datasets import data_dir
        from raft_tpu_torch.bench.io import load_real_dataset

        found = load_real_dataset(
            spec.get("root") or data_dir(),
            spec.get("name", "sift"), spec.get("max_rows"))
        if found is None:
            raise FileNotFoundError(
                f"real dataset {spec.get('name', 'sift')!r} not found")
        base, queries, _ = found
        return _as_f32(base, device), _as_f32(queries, device)
    if kind == "blobs":
        n, dim = int(spec["n"]), int(spec["dim"])
        q = int(spec.get("n_queries", 1000))
        data, _, _ = rt_random.make_blobs(
            int(spec.get("seed", 0)), n + q, dim,
            n_clusters=int(spec.get("n_clusters", 1024)),
            cluster_std=float(spec.get("cluster_std", 1.0)),
            center_box=(-8.0, 8.0), device=device,
        )
        return data[:n], data[n:]
    if kind == "siftlike":
        from raft_tpu_torch.bench.datasets import sift_like

        data, queries = sift_like(
            int(spec["n"]), int(spec.get("dim", 128)),
            int(spec.get("n_queries", 10_000)), int(spec.get("seed", 0)))
        return _as_f32(data, device), _as_f32(queries, device)
    raise ValueError(f"unknown dataset kind {kind!r}")


def _timed_qps(run, queries, reps: int) -> float:
    v, _ = run(queries)
    _force(v)
    t0 = time.perf_counter()
    for _ in range(reps):
        v, _ = run(queries)
    _force(v)
    return queries.shape[0] / ((time.perf_counter() - t0) / reps)


def _make_algo(name: str, build_params: Dict, dataset, k: int, metric: str,
               res: Resources):
    """Returns (build_fn() -> state, search_fn(state, sp, queries) -> (v, i)).

    ``metric`` (the config-level key) flows into every build unless the
    algo's own build params override it — recall vs ground truth is only
    meaningful when both rank under the same metric. Mutates ``build_params``
    in place so records report the metric actually used."""
    if name != "cagra":  # cagra build is metric-free (graph construction)
        build_params.setdefault("metric", metric)
    if name == "brute_force":
        return (lambda: brute_force.build(dataset, **build_params, res=res),
                lambda ix, sp, qs: brute_force.search(ix, qs, k, **sp,
                                                      res=res))
    if name == "ivf_flat":
        return (lambda: ivf_flat.build(
                    dataset, ivf_flat.IvfFlatParams(**build_params), res=res),
                lambda ix, sp, qs: ivf_flat.search(ix, qs, k, **sp, res=res))
    if name == "ivf_pq":
        def search_pq(ix, sp, qs):
            sp = dict(sp)
            ratio = int(sp.pop("refine_ratio", 1))
            if ratio > 1:
                _, cand = ivf_pq.search(ix, qs, k * ratio, **sp, res=res)
                return refine.refine(dataset, qs, cand, k,
                                     metric=build_params["metric"], res=res)
            return ivf_pq.search(ix, qs, k, **sp, res=res)

        return (lambda: ivf_pq.build(
                    dataset, ivf_pq.IvfPqParams(**build_params), res=res),
                search_pq)
    if name == "cagra":
        def search_cagra(ix, sp, qs):
            return cagra.search(ix, qs, k, cagra.CagraSearchParams(**sp),
                                res=res)

        return (lambda: cagra.build(dataset, cagra.CagraParams(**build_params),
                                    res=res),
                search_cagra)
    raise ValueError(f"unknown algo {name!r}")


def run_benchmark(config: Dict, reps: int = 3,
                  res: Optional[Resources] = None,
                  device=None) -> List[Dict]:
    """Run every (algo, search-params) combination; returns records sorted
    by algo then recall (the QPS@recall curve)."""
    res = resources_for(device, res)
    dataset, queries = _load_dataset(config["dataset"], res.device)
    k = int(config.get("k", 10))
    metric = config.get("metric", "sqeuclidean")

    gt_v, gt_i = brute_force.search(
        brute_force.build(dataset, metric=metric, res=res),
        queries, k, select_algo="exact", res=res,
    )
    _force(gt_v)

    records = []
    for algo in config["algos"]:
        name = algo["name"]
        build_params = dict(algo.get("build", {}))
        if name == "cagra" and metric != "sqeuclidean":
            raise ValueError("cagra bench entries support sqeuclidean only")
        build_fn, search_fn = _make_algo(name, build_params, dataset, k,
                                         metric, res)
        t0 = time.perf_counter()
        state = build_fn()
        _synchronize(res.device)  # the index's device: the build's barrier
        build_s = time.perf_counter() - t0

        for sp in algo.get("search", [{}]):
            v, i = search_fn(state, sp, queries)
            recall = float(stats.neighborhood_recall(i, gt_i, v, gt_v))
            qps = _timed_qps(lambda qs: search_fn(state, sp, qs), queries,
                             reps)
            records.append({
                "algo": name,
                "build_params": build_params,
                "search_params": sp,
                "build_s": round(build_s, 2),
                "qps": round(qps, 1),
                "recall": round(recall, 4),
                "k": k,
            })
        del state
    records.sort(key=lambda r: (r["algo"], r["recall"]))
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", help="JSON config path")
    ap.add_argument("-o", "--output", default=None, help="results JSON path")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        config = json.load(f)
    records = run_benchmark(config, reps=args.reps, device=args.device)
    text = json.dumps(records, indent=2)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
