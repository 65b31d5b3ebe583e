"""Fleet-wide metric aggregation (counterpart of
``raft_tpu/obs/aggregate.py``): merge per-process snapshots exactly, and
stitch per-process Chrome traces into one fleet timeline.

Every ``export_jsonl`` / heartbeat record is stamped with
``process_index``/``process_count`` (obs/tracing.process_info); this module
folds any number of those per-process snapshots into ONE fleet view — and the
merge is **exact**, not approximate:

* counters — integer/float sums, key-wise;
* timers — ``count``/``total_s`` sum, ``min_s``/``max_s`` min/max, mean
  recomputed from the merged totals; ``device_count``/``device_total_s``
  (a span's card time, where either side has it) sum;
* histograms — ``count``/``sum`` sum, ``min``/``max`` min/max, and the
  power-of-two buckets merged KEY-WISE (a bucket bound is a pure function of
  the observed value, so identical bounds on different processes are the
  same bucket — merging loses nothing the per-process histograms had);
* gauges — ``min`` min-of-min, ``max`` max-of-max, ``count`` sum, and the
  per-process LAST values preserved verbatim in the ``last`` map; the merged
  ``value`` is the max over preserved last values (the conservative fleet
  watermark).

Merging is associative and commutative (sums/mins/maxes of disjoint
streams); percentile upper bounds (:func:`percentile_bounds`, the ≤2×
bucket-bound estimates) are derived from the merged buckets, never merged
themselves. :func:`stitch_traces` gives each process its own ``host<i>``
track, namespaces host-local span ids, keeps the ``fleet_trace_id`` join
key verbatim, and subtracts each host's handshake ``offset_s``.

CLI::

    python -m raft_tpu_torch.obs.aggregate results/metrics/*.jsonl [--output f.json]
    python -m raft_tpu_torch.obs.aggregate --stitch p0.json p1.json \
        --handshakes rec.jsonl --output fleet.json

Stdlib only at module level (no torch): a parent that never imported the
port merges the files its children left, even when the child's import is
what failed.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Iterable, List, Optional

__all__ = [
    "main",
    "merge_files",
    "merge_records",
    "merge_snapshots",
    "percentile_bounds",
    "read_jsonl",
    "read_trace",
    "stitch_traces",
]

#: the quantiles snapshot()/export carry, as (key, q) pairs
QUANTILES = (("p50_ub", 0.50), ("p90_ub", 0.90), ("p99_ub", 0.99))


def percentile_bounds(buckets: dict, count: int) -> dict:
    """p50/p90/p99 UPPER-BOUND estimates from power-of-two buckets.

    A bucket key ``le_B`` counts observations with value ≤ B where B is the
    smallest power of two ≥ the value — so the true q-quantile lies in
    ``(B/2, B]`` of the first bucket whose cumulative count reaches
    ``ceil(q·count)``, and the returned bound over-estimates it by AT MOST
    2× (exactly the bucket resolution). Returns ``{}`` for an empty
    histogram."""
    if not count or not buckets:
        return {}
    bounds = []
    for key, n in buckets.items():
        try:
            bounds.append((float(str(key)[3:]), int(n)))
        except (ValueError, IndexError):
            continue
    if not bounds:
        return {}
    bounds.sort()
    out = {}
    for key, q in QUANTILES:
        need = max(1, math.ceil(q * count))
        cum = 0
        for bound, n in bounds:
            cum += n
            if cum >= need:
                out[key] = bound
                break
        else:
            out[key] = bounds[-1][0]
    return out


def _merge_timer(a: dict, b: dict) -> dict:
    count = a.get("count", 0) + b.get("count", 0)
    total = a.get("total_s", 0.0) + b.get("total_s", 0.0)
    out = {
        "count": count,
        "total_s": total,
        "min_s": min(a.get("min_s", math.inf), b.get("min_s", math.inf)),
        "max_s": max(a.get("max_s", 0.0), b.get("max_s", 0.0)),
        "mean_s": total / count if count else 0.0,
    }
    if "device_count" in a or "device_count" in b:
        out["device_count"] = a.get("device_count", 0) + \
            b.get("device_count", 0)
        out["device_total_s"] = a.get("device_total_s", 0.0) + \
            b.get("device_total_s", 0.0)
    return out


def _merge_hist(a: dict, b: dict) -> dict:
    buckets = dict(a.get("buckets") or {})
    for key, n in (b.get("buckets") or {}).items():
        buckets[key] = buckets.get(key, 0) + n
    count = a.get("count", 0) + b.get("count", 0)
    out = {
        "count": count,
        "sum": a.get("sum", 0.0) + b.get("sum", 0.0),
        "min": min(a.get("min", math.inf), b.get("min", math.inf)),
        "max": max(a.get("max", -math.inf), b.get("max", -math.inf)),
        "buckets": buckets,
    }
    out.update(percentile_bounds(buckets, count))
    return out


def _merge_gauge(a: dict, b: dict) -> dict:
    last = dict(a.get("last") or
                ({"p0": a["value"]} if "value" in a else {}))
    last.update(b.get("last") or
                ({"p0": b["value"]} if "value" in b else {}))
    out = {
        "min": min(a.get("min", math.inf), b.get("min", math.inf)),
        "max": max(a.get("max", -math.inf), b.get("max", -math.inf)),
        "count": a.get("count", 0) + b.get("count", 0),
        "last": last,
    }
    # the merged headline value: the max over preserved per-process last
    # values — conservative for usage-shaped gauges (memory watermarks,
    # queue depth), where the worst process IS the fleet answer. For
    # quality-shaped gauges (obs.shadow.recall), max hides the degraded
    # process — direction-sensitive consumers must read ``last``/``min``,
    # which is exactly why the per-process values are preserved verbatim
    if last:
        out["value"] = max(last.values())
    return out


def merge_snapshots(snaps: Iterable[dict]) -> dict:
    """Fold snapshot dicts ({"counters": .., "timers": .., "histograms": ..,
    "gauges": ..}) into one fleet snapshot, exactly (module docstring). Left
    fold in input order; the operation is associative/commutative up to
    float summation order, and bit-exact for counters, histogram buckets and
    gauge last-value maps."""
    counters: dict = {}
    timers: dict = {}
    hists: dict = {}
    gauges: dict = {}
    for snap in snaps:
        for key, val in (snap.get("counters") or {}).items():
            counters[key] = counters.get(key, 0) + val
        for key, val in (snap.get("timers") or {}).items():
            timers[key] = _merge_timer(timers[key], val) if key in timers \
                else dict(val)
        for key, val in (snap.get("histograms") or {}).items():
            hists[key] = _merge_hist(hists[key], val) if key in hists \
                else _merge_hist({}, val)
        for key, val in (snap.get("gauges") or {}).items():
            gauges[key] = _merge_gauge(gauges[key], val) if key in gauges \
                else _merge_gauge({}, val)
    return {"counters": counters, "timers": timers, "histograms": hists,
            "gauges": gauges}


def merge_records(records: List[dict]) -> dict:
    """Fleet view from export_jsonl-shaped records: keep the NEWEST snapshot
    per (source, process_index) — each line is a cumulative snapshot of its
    process, so merging two generations of the same process would double
    count — then merge the survivors. Returns the merged snapshot plus
    provenance (``processes``, ``process_count``, t range)."""
    latest: dict = {}
    offsets: dict = {}
    for rec in records:
        if rec.get("type") == "clock_offset":
            # the flight recorder's per-process handshake: NOT a metrics
            # snapshot — folding it into ``latest`` would let a newer
            # handshake supersede (and erase) its process's real snapshot.
            # Newest handshake per process wins; the fold is a key-wise
            # max-by-t, so grouping cannot change it (associativity).
            pi = rec.get("process_index", 0)
            prev = offsets.get(pi)
            if prev is None or rec.get("t", 0) >= prev.get("t", 0):
                offsets[pi] = rec
            continue
        src = rec.get("_source", "")
        key = (src, rec.get("process_index", 0))
        prev = latest.get(key)
        if prev is None or rec.get("t", 0) >= prev.get("t", 0):
            latest[key] = rec
    picked = [latest[k] for k in sorted(latest, key=str)]
    merged = merge_snapshots(picked)
    procs = sorted({r.get("process_index", 0) for r in picked})
    merged["processes"] = procs
    merged["process_count"] = max(
        [r.get("process_count", 1) for r in picked] + [len(procs)])
    ts = [r["t"] for r in picked if isinstance(r.get("t"), (int, float))]
    if ts:
        merged["t_min"] = min(ts)
        merged["t_max"] = max(ts)
    if offsets:
        merged["clock_offsets"] = {
            f"p{pi}": {key: rec.get(key) for key in
                       ("offset_s", "t_epoch", "t_mono", "t")
                       if key in rec}
            for pi, rec in sorted(offsets.items())}
    return merged


def read_jsonl(path: str) -> List[dict]:
    """Parse one metrics JSONL file, skipping torn/corrupt lines (the same
    tolerance bench/progress.read_progress gives heartbeat files). Each
    record is tagged with its source path for per-process dedup."""
    records = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict):
                    rec["_source"] = path
                    records.append(rec)
    except OSError:
        return []
    return records


def merge_files(paths: Iterable[str]) -> dict:
    """Read + merge any number of per-process metrics JSONL files."""
    records: List[dict] = []
    sources = []
    for path in paths:
        recs = read_jsonl(path)
        if recs:
            sources.append(path)
        records.extend(recs)
    out = merge_records(records)
    out["sources"] = sources
    return out


def read_trace(path: str) -> Optional[dict]:
    """Load one per-process Chrome trace export (obs/tracing.chrome_trace
    shape). Returns None for unreadable/garbage files — a dead child's
    torn trace must cost one track, not the stitch."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(doc, dict) or \
            not isinstance(doc.get("traceEvents"), list):
        return None
    return doc


def stitch_traces(docs: Iterable[Optional[dict]],
                  clock_offsets: Optional[dict] = None) -> dict:
    """Fold per-process Chrome traces (``trace_bench_p{i}.json`` exports)
    into ONE fleet timeline loadable as a single Perfetto file.

    Each source keeps its own ``pid`` track (a ``process_name`` metadata
    event labels it ``host<i>``); two exports claiming the same
    process_index — the id-collision case — are re-homed on the next free
    track, never merged. Host-LOCAL span/trace ids are namespaced
    ``p<i>/<id>`` so pid-counter collisions across hosts stay distinct,
    while the ``fleet_trace_id`` attr (obs/tracing.fleet_trace_id) is left
    verbatim — it is the cross-host join key, one fleet trace over
    distinct host tracks. ``clock_offsets`` (merge_records' fold of the
    flight recording's handshake records, ``{"p<i>": {"offset_s": ..}}``)
    shifts each host's timestamps onto the shared reference clock."""
    events: list = []
    used: set = set()
    counts = [1]
    sources = []
    for slot, doc in enumerate(d for d in docs if d is not None):
        meta = doc.get("otherData") or {}
        pi = int(meta.get("process_index", slot))
        while pi in used:
            pi += 1
        used.add(pi)
        counts.append(int(meta.get("process_count", 1) or 1))
        sources.append({"process_index": pi, **{
            k: v for k, v in meta.items() if k != "process_index"}})
        off_s = 0.0
        if clock_offsets:
            row = clock_offsets.get(f"p{pi}") or clock_offsets.get(pi) or {}
            try:
                off_s = float(row.get("offset_s", 0.0) or 0.0)
            except (TypeError, ValueError):
                off_s = 0.0
        events.append({"name": "process_name", "ph": "M", "pid": pi,
                       "args": {"name": f"host{pi}"}})
        for ev in doc.get("traceEvents", []):
            if not isinstance(ev, dict):
                continue
            ev = dict(ev)
            ev["pid"] = pi
            if off_s and isinstance(ev.get("ts"), (int, float)):
                ev["ts"] = round(ev["ts"] - off_s * 1e6, 1)
            args = ev.get("args")
            if isinstance(args, dict):
                args = dict(args)
                for key in ("trace_id", "span_id", "parent_id"):
                    if args.get(key):
                        args[key] = f"p{pi}/{args[key]}"
                ev["args"] = args
            events.append(ev)
    # metadata events first (no ts), then chronological across hosts
    events.sort(key=lambda e: (e.get("ph") != "M",
                               e["ts"] if isinstance(e.get("ts"),
                                                     (int, float)) else 0.0))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "stitched": True,
            "processes": sorted(used),
            "process_count": max(counts + [len(used)]),
            "sources": sources,
        },
    }


def _emit(text: str, output: Optional[str]) -> None:
    if output:
        with open(output, "w") as f:
            f.write(text + "\n")
            f.flush()
    else:
        print(text)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.obs.aggregate",
        description="Merge per-process obs metrics JSONL files into one "
                    "fleet-wide snapshot (exact for counters and "
                    "power-of-two histograms), or stitch per-process "
                    "Chrome traces into one fleet timeline (--stitch).")
    ap.add_argument("files", nargs="+",
                    help="metrics JSONL files (or Chrome trace JSON files "
                         "with --stitch)")
    ap.add_argument("--stitch", action="store_true",
                    help="treat files as per-process Chrome traces and "
                         "fold them into ONE fleet trace with per-host "
                         "tracks")
    ap.add_argument("--handshakes", default=None, metavar="PATH",
                    help="flight recording JSONL whose clock_offset "
                         "handshake records align host clocks in the "
                         "stitch")
    ap.add_argument("--output", default=None, metavar="PATH",
                    help="write the fleet view here instead of stdout")
    ap.add_argument("--indent", type=int, default=2)
    args = ap.parse_args(argv)
    if args.stitch:
        docs = [read_trace(p) for p in args.files]
        if not any(d is not None for d in docs):
            print("aggregate: no loadable traces in "
                  f"{', '.join(args.files)}", file=sys.stderr)
            return 2
        offsets = None
        if args.handshakes:
            offsets = merge_records(
                read_jsonl(args.handshakes)).get("clock_offsets")
        doc = stitch_traces(docs, clock_offsets=offsets)
        _emit(json.dumps(doc, indent=args.indent, sort_keys=True),
              args.output)
        return 0
    fleet = merge_files(args.files)
    if not fleet.get("sources"):
        print("aggregate: no parseable records in "
              f"{', '.join(args.files)}", file=sys.stderr)
        return 2
    _emit(json.dumps(fleet, indent=args.indent, sort_keys=True),
          args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
