"""Unified serving status (counterpart of ``raft_tpu/obs/report.py``): one
JSON snapshot of the whole observability plane, streamable as JSONL through
the crash-safe bench/progress channel.

``collect()`` folds every signal the plane produces into a single
self-describing record — SLO states with dual-window burn rates
(obs/slo.py), queue depth and adaptive batch cap (serving.QueryQueue),
the live shadow-recall estimate ± its Wilson CI (obs/shadow.py), memory
watermarks (obs/memory.py gauges), shard health (resilience), the compile
ledger (obs/compile.py: in the port a record is a new operand signature,
and the only unexplained one is a kernel library ``native.<source>``
loaded twice), the admission counters (obs/costmodel.py), the roofline
against the card's peaks (obs/roofline.py), and the request verdict
counters with an explicit ``unclassified`` residue (which a healthy run
keeps at zero). ``export()`` appends it to a JSONL stream with the
heartbeat file's durability (fsync per record, via
``bench/progress.export_metrics``), so a wedged serving process still
leaves its last known status on disk.

The record schema — :data:`SCHEMA_VERSION`, section names, and the
:func:`validate` verdict on a record — is the JAX package's.

CLI::

    python -m raft_tpu_torch.obs.report results/obs_report.jsonl   # newest record
    python -m raft_tpu_torch.obs.report path --validate            # health gate

``--validate`` re-checks the structural invariants (:func:`validate`): all
three SLO classes present with finite burn rates, a populated recall
estimate with CI bounds, a nonzero memory watermark, zero unclassified
verdicts. With no path the CLI renders the *current process*'s plane
(useful inside a serving process; standalone it is an empty-but-valid
skeleton).
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import sys
import time
from typing import Optional

from raft_tpu_torch import obs, resilience

__all__ = ["SCHEMA_VERSION", "collect", "export", "main", "render",
           "validate"]

#: Record schema stamped by :func:`collect` — :func:`validate` keys its
#: leniency off this field instead of probing section shapes. History
#: (the JAX package's, kept so both packages' records validate alike):
#: 1 = SLO/recall/queue/memory/shard_health/verdicts;
#: 2 = + compile ledger and admission sections;
#: 3 = + roofline section;
#: 4 = + capacity section, explicit version + window stamps;
#: 5 = + maintenance section (drift/re-clustering manager);
#: 6 = + tuning section (burn-rate controller actions).
#: Records with NO version field are legacy streams: every later section
#: is lenient-on-absence for them, exactly as before the stamp existed.
SCHEMA_VERSION = 6

#: monotonic window id for records collect() stamps itself (a caller-run
#: windowed sampler — obs/flight.py — passes its own instead)
_WINDOWS = itertools.count()

#: verdict counters summarized into the report (everything the queue stamps)
_VERDICT_PREFIX = "serving.requests."


def _compile_summary() -> dict:
    """The compile ledger's report section (lazy import: obs/compile is
    kept off the package import path like the rest of the SLO plane)."""
    from raft_tpu_torch.obs import compile as obs_compile

    return obs_compile.summary(recent=3)


def _admission_counts(counters: dict) -> dict:
    """Verdict counts via the one shared namespace fold (costmodel owns
    the prefix; lazy import as above)."""
    from raft_tpu_torch.obs import costmodel

    return costmodel.admission_counts(counters)


def _roofline_summary(snapshot: dict) -> dict:
    """The roofline plane's report section (lazy import like the
    rest of the SLO plane): per-entry static FLOP/byte model + measured
    fold + occupancy, against the platform peak table."""
    from raft_tpu_torch.obs import roofline

    return roofline.summary(snapshot=snapshot)


def _classified(fn, label: str, out_errors: dict):
    """Run one provider; a failure degrades its section to None and lands
    classified in ``errors`` — a status report must report, not raise."""
    try:
        return fn()
    except Exception as e:
        out_errors[label] = resilience.classify(e)
        return None


def collect(engine=None, sampler=None, queue=None, capacity=None,
            maintenance=None, controller=None,
            snapshot: Optional[dict] = None,
            extra: Optional[dict] = None,
            window: Optional[int] = None) -> dict:
    """One status snapshot of the observability plane. Every section
    degrades independently (classified into ``errors``) so a broken
    provider never costs the rest of the report. ``capacity``
    is a :class:`raft_tpu_torch.serving.CapacityController`; its per-tenant
    section (tiers, residency bytes, verdict counts, SLO rows, promote
    latency) rides the report and is structurally gated by
    :func:`validate`. Every record is stamped with :data:`SCHEMA_VERSION`
    and a ``window`` id (the flight recorder passes its own;
    otherwise a process-local counter — a report STREAM is ordered by more
    than wall-clock t)."""
    with obs.record_span("obs.report::collect"):
        errors: dict = {}
        snap = snapshot if snapshot is not None else \
            _classified(obs.snapshot, "snapshot", errors) or {}
        counters = snap.get("counters") or {}
        verdicts = {k[len(_VERDICT_PREFIX):]: v for k, v in counters.items()
                    if k.startswith(_VERDICT_PREFIX)}
        # "rejected": the capacity controller's classified
        # admission rejection is a first-class outcome, never residue
        known = {"ok", "deadline", "fatal", "oom", "transient", "rejected"}
        out = {
            "t": round(time.time(), 3),
            "type": "obs_report",
            "schema_version": SCHEMA_VERSION,
            "window": int(window) if window is not None else next(_WINDOWS),
            "slo": (_classified(engine.evaluate, "slo", errors)
                    if engine is not None else {}),
            "recall": (_classified(sampler.estimate, "recall", errors)
                       if sampler is not None else None),
            "queue": (_classified(
                lambda: {"depth": queue.depth,
                         "batch_cap": queue.batch_cap,
                         "batches": queue.batches,
                         "multi_batches": queue.multi_batches,
                         "requeued": int(counters.get(
                             "serving.queue.requeued", 0))},
                "queue", errors) if queue is not None else None),
            "memory": {k: {"value": g.get("value"), "max": g.get("max")}
                       for k, g in (snap.get("gauges") or {}).items()
                       if k.startswith("memory.")},
            # compile ledger: total records, per-entry counts,
            # the unexplained residue (zero on a healthy run) and the
            # newest shape-diffed records — "did anything retrace, and
            # which operand caused it" straight from the status snapshot
            "compile": _classified(_compile_summary, "compile", errors),
            # pre-dispatch admission verdict counters (obs/costmodel.py):
            # a healthy over-subscribed plane queues/rejects CLASSIFIED
            # instead of OOMing — the counts the capacity controller
            # consumes
            "admission": _classified(
                lambda: _admission_counts(counters), "admission", errors),
            # roofline plane: per-dispatch FLOP/byte model vs
            # platform peaks + sync-mode measured durations — "is the
            # hardware actually being used" straight from the snapshot
            "roofline": _classified(
                lambda: _roofline_summary(snap), "roofline", errors),
            "shard_health": _classified(
                lambda: resilience.shard_health().snapshot(),
                "shard_health", errors),
            # capacity plane: per-tenant residency tiers +
            # budget + verdict counts + SLO rows
            "capacity": (_classified(capacity.report, "capacity", errors)
                         if capacity is not None else None),
            # maintenance plane (schema v5): drift score + incremental
            # re-clustering cycle counts — the always-live index's
            # "is recall holding without a rebuild" record
            "maintenance": (_classified(maintenance.report, "maintenance",
                                        errors)
                            if maintenance is not None else None),
            # tuning plane (schema v6): the burn-rate controller's action
            # ledger — what the online loop DID to the knobs this stream,
            # and where they sit relative to the tuned operating point
            "tuning": (_classified(controller.report, "tuning", errors)
                       if controller is not None else None),
            "verdicts": {
                **verdicts,
                "unclassified": int(sum(
                    v for k, v in verdicts.items() if k not in known)),
            },
        }
        # round id (launcher-stamped): lets a multi-round archive key reports
        # without parsing file names
        round_id = os.environ.get("RAFT_TPU_OBS_ROUND", "").strip()
        if round_id:
            out["round"] = round_id
        if errors:
            out["errors"] = errors
        if extra:
            out.update(extra)
        return out


def export(path: str, report: dict) -> dict:
    """Append one report record to a JSONL stream through the crash-safe
    bench/progress channel (fsync per record; the only sanctioned results/
    write path). Returns the record written."""
    # bench/progress is stdlib-only and imports nothing from raft_tpu_torch —
    # reaching it from obs keeps the one fsync'd JSONL writer shared
    from raft_tpu_torch.bench import progress

    return progress.export_metrics(path, report)


def render(report: Optional[dict] = None, indent: int = 2, **providers) -> str:
    """Pretty-printed JSON of ``report`` (default: a fresh
    :func:`collect` over ``providers``)."""
    with obs.record_span("obs.report::render"):
        if report is None:
            report = collect(**providers)
        return json.dumps(report, indent=indent, sort_keys=True,
                          default=str)


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def validate(report: dict,
             require_classes=("latency", "availability", "recall")) -> list:
    """Structural health of one report record: the list of problems (empty
    = valid). Checks the acceptance invariants: every required SLO class
    present with finite burn rates, recall estimate populated with CI
    bounds, a nonzero memory watermark, zero unclassified verdicts.

    Section presence is keyed off the record's ``schema_version`` stamp
    (:data:`SCHEMA_VERSION` history): a version that declares a section
    (compile ≥ 2, roofline ≥ 3) must carry it — either populated or
    degraded-classified in ``errors``. Unversioned records are legacy
    streams and stay lenient on absence."""
    problems = []
    version = report.get("schema_version")
    version = version if isinstance(version, int) else 0
    errors = report.get("errors") or {}
    slo = report.get("slo") or {}
    kinds = {row.get("kind") for row in slo.values()
             if isinstance(row, dict)}
    for cls in require_classes:
        if cls not in kinds:
            problems.append(f"missing SLO class {cls!r} "
                            f"(declared: {sorted(kinds)})")
    for name, row in slo.items():
        if not isinstance(row, dict):
            problems.append(f"slo[{name}] is not a record")
            continue
        if row.get("state") == "unknown":
            problems.append(f"slo[{name}] source failed (state=unknown)")
            continue
        for key in ("burn_fast", "burn_slow"):
            if not _finite(row.get(key)):
                problems.append(f"slo[{name}].{key} not finite: "
                                f"{row.get(key)!r}")
    rec = report.get("recall")
    if "recall" in require_classes:
        if not isinstance(rec, dict) or rec.get("recall") is None:
            problems.append("recall estimate not populated")
        elif not (_finite(rec.get("ci_low")) and _finite(rec.get("ci_high"))
                  and rec["ci_low"] <= rec["recall"] <= rec["ci_high"]):
            problems.append(f"recall CI malformed: {rec!r}")
    mem = report.get("memory") or {}
    if not any(_finite(g.get("value")) and g["value"] > 0
               for g in mem.values() if isinstance(g, dict)):
        problems.append("no nonzero memory watermark recorded")
    verdicts = report.get("verdicts") or {}
    if verdicts.get("unclassified", 0):
        problems.append(
            f"{verdicts['unclassified']} unclassified verdict(s)")
    # compile ledger: every retrace must carry a shape-diff — an
    # unexplained retrace is a zero-recompile-contract violation. Schema
    # v2+ declares the section, so its absence (without a classified
    # degradation) is itself a problem; unversioned legacy streams pass.
    comp = report.get("compile")
    if isinstance(comp, dict) and comp.get("unexplained_retraces", 0):
        problems.append(
            f"{comp['unexplained_retraces']} unexplained retrace(s) "
            f"in the compile ledger")
    elif not isinstance(comp, dict) and version >= 2 \
            and "compile" not in errors:
        problems.append(
            f"schema v{version} record missing its compile section")
    # roofline plane: every noted entry must carry a finite positive byte
    # model, a sane bound verdict, and FLOPs consistent with its own
    # intensity; peaks must state their provenance (a made-up denominator
    # is worse than an unknown one). Schema v3+ declares the section
    # (absence without a classified degradation is a problem); unversioned
    # legacy streams pass.
    roof = report.get("roofline")
    if not isinstance(roof, dict) and version >= 3 \
            and "roofline" not in errors:
        problems.append(
            f"schema v{version} record missing its roofline section")
    if isinstance(roof, dict):
        peaks = roof.get("peaks") or {}
        if peaks.get("source") not in ("env", "table", "unknown"):
            problems.append(
                f"roofline peaks carry no provenance: {peaks!r}")
        for name, row in (roof.get("entries") or {}).items():
            if not isinstance(row, dict):
                problems.append(f"roofline[{name}] is not a record")
                continue
            if not (_finite(row.get("flops")) and row["flops"] >= 0):
                problems.append(f"roofline[{name}].flops not finite: "
                                f"{row.get('flops')!r}")
            if not (_finite(row.get("bytes")) and row["bytes"] > 0):
                problems.append(f"roofline[{name}].bytes not positive: "
                                f"{row.get('bytes')!r}")
            if row.get("bound") not in ("compute", "memory", "unknown"):
                problems.append(f"roofline[{name}].bound invalid: "
                                f"{row.get('bound')!r}")
            if peaks.get("source") == "unknown" and \
                    row.get("bound") != "unknown":
                problems.append(
                    f"roofline[{name}] claims bound={row['bound']!r} "
                    f"with unknown peaks")
    # capacity plane (schema v4): every tenant must sit in a known tier
    # with sane residency accounting, and the budgeter invariant —
    # predicted resident bytes never exceed a known budget — must hold in
    # the snapshot. Lenient on absence at EVERY version: collect() emits
    # None whenever no capacity controller is wired, which is the normal
    # single-tenant shape, not a legacy artifact.
    cap = report.get("capacity")
    if isinstance(cap, dict):
        budget = cap.get("budget_bytes")
        resident = cap.get("resident_bytes")
        if not (_finite(resident) and resident >= 0):
            problems.append(
                f"capacity.resident_bytes not finite: {resident!r}")
        elif _finite(budget) and budget > 0 and resident > budget:
            problems.append(
                f"capacity budgeter overcommitted: resident "
                f"{resident} > budget {budget}")
        for name, row in (cap.get("tenants") or {}).items():
            if not isinstance(row, dict):
                problems.append(f"capacity.tenants[{name}] is not a record")
                continue
            if row.get("tier") not in ("hot", "warm", "cold"):
                problems.append(
                    f"capacity.tenants[{name}].tier invalid: "
                    f"{row.get('tier')!r}")
            if not (_finite(row.get("resident_bytes"))
                    and row["resident_bytes"] >= 0):
                problems.append(
                    f"capacity.tenants[{name}].resident_bytes not "
                    f"finite: {row.get('resident_bytes')!r}")
            if not isinstance(row.get("slo"), dict):
                problems.append(
                    f"capacity.tenants[{name}] carries no SLO row")
    # maintenance plane (schema v5): a populated section must carry a
    # finite non-negative drift score, integral cycle accounting, and a
    # recall record. Lenient on absence at every version (None = no
    # manager wired — the static-index shape), and lenient on SHAPE below
    # v5: an older stream replaying through a newer validator must not
    # fail on a section its writer never promised.
    maint = report.get("maintenance")
    if isinstance(maint, dict) and version >= 5:
        score = maint.get("drift_score")
        if not (_finite(score) and score >= 0):
            problems.append(
                f"maintenance.drift_score not finite: {score!r}")
        for key in ("cycles", "stale_aborts", "failures"):
            v = maint.get(key)
            if not (isinstance(v, int) and v >= 0):
                problems.append(
                    f"maintenance.{key} not a non-negative int: {v!r}")
        if not isinstance(maint.get("recall"), dict):
            problems.append("maintenance section carries no recall record")
    # tuning plane (schema v6): a populated section must carry integral
    # action accounting (actions = nudges + reverts — an action that is
    # neither is an unclassified knob move) and a knob map. Lenient on
    # absence at every version (None = no controller wired — the
    # uncontrolled shape), lenient on SHAPE below v6 like maintenance.
    tun = report.get("tuning")
    if isinstance(tun, dict) and version >= 6:
        for key in ("actions", "nudges", "reverts", "holds", "failures"):
            v = tun.get(key)
            if not (isinstance(v, int) and v >= 0):
                problems.append(
                    f"tuning.{key} not a non-negative int: {v!r}")
        if isinstance(tun.get("actions"), int) \
                and isinstance(tun.get("nudges"), int) \
                and isinstance(tun.get("reverts"), int) \
                and tun["actions"] != tun["nudges"] + tun["reverts"]:
            problems.append(
                f"tuning action ledger inconsistent: actions "
                f"{tun['actions']} != nudges {tun['nudges']} + reverts "
                f"{tun['reverts']}")
        if not isinstance(tun.get("knobs"), dict):
            problems.append("tuning section carries no knob map")
    return problems


def _load_newest(path: str) -> Optional[dict]:
    """Newest obs_report record in a JSONL stream (torn lines skipped —
    the read_progress tolerance)."""
    newest = None
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
                if isinstance(rec, dict) and rec.get("type") == "obs_report":
                    if newest is None or rec.get("t", 0) >= newest.get("t", 0):
                        newest = rec
    except OSError:
        return None
    return newest


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.obs.report",
        description="Render (and optionally validate) one observability-"
                    "plane status snapshot: SLO burn rates, queue depth, "
                    "shadow-recall estimate, memory watermarks, shard "
                    "health.")
    ap.add_argument("path", nargs="?", default=None,
                    help="obs-report JSONL stream (newest record wins); "
                         "omit to collect from the current process")
    ap.add_argument("--validate", action="store_true",
                    help="exit 1 unless the record passes validate()")
    ap.add_argument("--output", default=None, metavar="PATH",
                    help="write the rendered JSON here instead of stdout")
    ap.add_argument("--indent", type=int, default=2)
    args = ap.parse_args(argv)

    if args.path:
        report = _load_newest(args.path)
        if report is None:
            print(f"report: no obs_report records in {args.path}",
                  file=sys.stderr)
            return 2
    else:
        report = collect()
    text = render(report, indent=args.indent)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text + "\n")
            f.flush()
    else:
        print(text)
    if args.validate:
        problems = validate(report)
        if problems:
            for p in problems:
                print(f"report: INVALID: {p}", file=sys.stderr)
            return 1
        print("report: valid", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
