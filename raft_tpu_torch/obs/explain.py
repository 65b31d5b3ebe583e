"""Attribution engine (counterpart of ``raft_tpu/obs/explain.py``): "why is
this operating point slow", as a record.

The obs report carries the *evidence*: the roofline ``bound``/utilization
verdicts (obs/roofline.py), occupancy fractions, the compile ledger's
new-signature counts, the admission verdict counters, the queue
depth/batch-cap pair, the shadow-recall Wilson CI, the SLO burn states.
:func:`explain` folds one ``obs.report.collect()`` record (plus,
optionally, the previous window's record for cumulative-counter deltas)
into a **ranked, classified diagnosis list**: every entry one of
:data:`KINDS`, scored 0..1, with the evidence fields that produced it
attached. The autotuner's rule table (tuning/autotune.py) keys knob moves
off the top diagnosis; the burn-rate controller (serving/controller.py)
stamps it into every ``tuning.action`` event.

A pure function of report dicts: the same records give the same diagnosis
as the JAX package's, so kind names, thresholds and the record schema are
the JAX package's. On the card the roofline evidence is the H100's:
``mxu_utilization`` is the compute share of the card's peak (the field and
kind keep the JAX names, which are the schema and ``RULE_TABLE``'s keys),
``hbm_bw_utilization`` the share of its memory rate.

Diagnosis kinds:

* ``mxu_underfill``  — compute-bound but the compute units sit idle (small
  batch, thin query tile): raise the arithmetic per dispatch.
* ``hbm_bound``      — the scan streams more bytes than the FLOPs justify:
  shrink bytes/vector (lower ``bits``, engine switch).
* ``padding_waste``  — a large padded fraction of each dispatch is dead
  rows: fix tiling/page fill, not clock speed.
* ``recall_limited`` — the recall SLO burns (or the CI sits under its
  floor): spend latency on nprobe/k_fetch, nothing else helps.
* ``queue_limited``  — requests back up behind the batch cap while the
  device is fine: raise the cap / widen batching.
* ``capacity_limited`` — the admission controller queues/rejects: the
  working set does not fit, tier or shrink it.
* ``retrace_tax``    — compile-ledger records (new operand signatures, a
  kernel library loaded again) landed inside the window: every one eats
  the budget.
* ``unknown``        — pressure without evidence (or the evidence plane
  itself degraded): explicitly classified, never silent.

A HEALTHY window — no SLO burning, no degraded sections, no backlog —
yields an *empty* diagnosis list (``healthy=True``), not ``unknown``.
``validate()`` checks the structural contract of an explain record the
same way obs.report/obs.flight validate theirs.
"""

from __future__ import annotations

import math
from typing import Optional

from raft_tpu_torch import obs

__all__ = ["KINDS", "SCHEMA_VERSION", "explain", "validate"]

#: explain record schema (independent of the report's version — the
#: ``report_schema`` field carries the input's stamp)
SCHEMA_VERSION = 1

#: every diagnosis kind explain() may emit, in no particular order —
#: ranking is by score, per record
KINDS = ("mxu_underfill", "hbm_bound", "padding_waste", "recall_limited",
         "queue_limited", "capacity_limited", "retrace_tax", "unknown")

#: compute share of the peak (``mxu_utilization``) below this on a
#: compute-bound entry is underfill
_MXU_FLOOR = 0.5
#: padded fraction at/above this is tiling waste worth a knob move
_PAD_FLOOR = 0.25
#: queue depth beyond this multiple of the batch cap is a backlog
_DEPTH_RATIO = 2.0

#: report sections whose degradation blinds the attribution — a window
#: missing these can only be diagnosed ``unknown``
_EVIDENCE_SECTIONS = ("roofline", "compile", "admission", "queue",
                      "recall", "slo")


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def _clamp(x: float) -> float:
    return max(0.0, min(1.0, float(x)))


def _dominant_roofline(roof: dict) -> Optional[tuple]:
    """The entry that dominates the window's device time: highest
    measured seconds when available, else most dispatches."""
    best_name, best_row, best_key = None, None, (-1.0, -1.0)
    for name, row in (roof.get("entries") or {}).items():
        if not isinstance(row, dict):
            continue
        measured = row.get("measured_s")
        key = (measured if _finite(measured) else -1.0,
               float(row.get("dispatches") or 0))
        if key > best_key:
            best_name, best_row, best_key = name, row, key
    return (best_name, best_row) if best_row is not None else None


def _slo_pressure(slo: dict) -> dict:
    """SLO rows currently burning, by name → state (warn/breach)."""
    out = {}
    for name, row in (slo or {}).items():
        if isinstance(row, dict) and row.get("state") in ("warn", "breach"):
            out[name] = row["state"]
    return out


def _delta(cur, prev) -> Optional[int]:
    """Window-local delta of a cumulative counter (None when either side
    is missing — absence must not masquerade as zero)."""
    if not (_finite(cur) and _finite(prev)):
        return None
    return int(cur) - int(prev)


def explain(report: dict, prev: Optional[dict] = None) -> dict:
    """Fold one obs-report record into a ranked diagnosis record.

    ``prev`` (optional) is the PREVIOUS window's report from the same
    stream: cumulative counters (compile traces, admission verdicts)
    diff into window-local evidence with it; without it those detectors
    fall back to the cumulative values (first window of a recording).
    Raises ``ValueError`` on a non-report input — the explainer explains
    records, it does not invent them.
    """
    if not isinstance(report, dict) or report.get("type") != "obs_report":
        raise ValueError(
            f"explain() wants an obs_report record, got "
            f"{type(report).__name__}"
            + (f" of type {report.get('type')!r}"
               if isinstance(report, dict) else ""))
    with obs.record_span("obs.explain::explain",
                         attrs={"window": report.get("window")}):
        return _explain(report, prev if isinstance(prev, dict) else None)


def _explain(report: dict, prev: Optional[dict]) -> dict:
    diagnoses: list = []
    errors = report.get("errors") or {}
    slo = report.get("slo") if isinstance(report.get("slo"), dict) else {}
    pressure = _slo_pressure(slo)

    # -- retrace_tax: the compile ledger moved inside the window ----------
    comp = report.get("compile")
    if isinstance(comp, dict):
        unexplained = comp.get("unexplained_retraces") or 0
        total = comp.get("total_traces")
        prev_comp = (prev or {}).get("compile")
        d_traces = _delta(total, (prev_comp or {}).get("total_traces")) \
            if isinstance(prev_comp, dict) else None
        if unexplained:
            diagnoses.append({
                "kind": "retrace_tax", "score": 1.0,
                "evidence": {"unexplained_retraces": int(unexplained),
                             "total_traces": total}})
        elif d_traces:
            diagnoses.append({
                "kind": "retrace_tax",
                "score": _clamp(0.5 + 0.1 * d_traces),
                "evidence": {"traces_this_window": d_traces,
                             "total_traces": total}})

    # -- recall_limited: the one diagnosis latency cannot buy back --------
    rec = report.get("recall")
    recall_rows = [(n, r) for n, r in slo.items()
                   if isinstance(r, dict) and r.get("kind") == "recall"]
    for name, row in recall_rows:
        state = row.get("state")
        if state in ("warn", "breach"):
            diagnoses.append({
                "kind": "recall_limited",
                "score": 0.9 if state == "breach" else 0.6,
                "evidence": {"slo": name, "state": state,
                             "target": row.get("target"),
                             "value": row.get("value"),
                             "burn_fast": row.get("burn_fast")}})
            break
    else:
        if isinstance(rec, dict) and recall_rows:
            floor = recall_rows[0][1].get("target")
            ci_high = rec.get("ci_high")
            if _finite(floor) and _finite(ci_high) and ci_high < floor:
                diagnoses.append({
                    "kind": "recall_limited",
                    "score": _clamp(0.5 + (floor - ci_high)),
                    "evidence": {"ci_high": ci_high, "floor": floor,
                                 "recall": rec.get("recall"),
                                 "samples": rec.get("samples")}})

    # -- capacity_limited: the admission controller said no ---------------
    adm = report.get("admission")
    if isinstance(adm, dict):
        prev_adm = (prev or {}).get("admission")
        cur = {k: int(adm.get(k) or 0) for k in ("admit", "queue", "reject")}
        if isinstance(prev_adm, dict):
            for k in cur:
                d = _delta(cur[k], prev_adm.get(k) or 0)
                cur[k] = d if d is not None and d >= 0 else cur[k]
        denied = cur["queue"] + cur["reject"]
        if denied:
            diagnoses.append({
                "kind": "capacity_limited",
                "score": _clamp(denied / max(1, denied + cur["admit"])),
                "evidence": {"queued": cur["queue"],
                             "rejected": cur["reject"],
                             "admitted": cur["admit"]}})

    # -- queue_limited: backlog behind the batch cap ----------------------
    q = report.get("queue")
    if isinstance(q, dict):
        depth = q.get("depth")
        cap = q.get("batch_cap")
        if _finite(depth) and _finite(cap) and cap > 0 \
                and depth >= _DEPTH_RATIO * cap:
            diagnoses.append({
                "kind": "queue_limited",
                "score": _clamp(depth / (8.0 * cap)),
                "evidence": {"depth": int(depth), "batch_cap": int(cap),
                             "requeued": q.get("requeued")}})

    # -- roofline triplet on the dominant entry ---------------------------
    roof = report.get("roofline")
    dom = _dominant_roofline(roof) if isinstance(roof, dict) else None
    if dom is not None:
        name, row = dom
        bound = row.get("bound")
        mxu = row.get("mxu_utilization")
        hbm = row.get("hbm_bw_utilization")
        if bound == "memory":
            diagnoses.append({
                "kind": "hbm_bound",
                "score": _clamp(hbm) if _finite(hbm) else 0.6,
                "evidence": {"entry": name,
                             "hbm_bw_utilization": hbm,
                             "mxu_utilization": mxu,
                             "bytes": row.get("bytes")}})
        elif bound == "compute" and _finite(mxu) and mxu < _MXU_FLOOR:
            occ = row.get("occupancy") or {}
            diagnoses.append({
                "kind": "mxu_underfill",
                "score": _clamp(1.0 - mxu),
                "evidence": {"entry": name, "mxu_utilization": mxu,
                             "tile_fill": occ.get("tile_fill"),
                             "mxu_m_fill": occ.get("mxu_m_fill")}})
        pad = row.get("padded_fraction")
        if _finite(pad) and pad >= _PAD_FLOOR:
            diagnoses.append({
                "kind": "padding_waste", "score": _clamp(pad),
                "evidence": {"entry": name, "padded_fraction": pad}})

    # -- unknown: pressure or blindness without an attribution ------------
    degraded = {s: errors[s] for s in _EVIDENCE_SECTIONS if s in errors}
    if degraded:
        diagnoses.append({
            "kind": "unknown", "score": 0.5,
            "evidence": {"degraded": degraded}})
    elif pressure and not diagnoses:
        diagnoses.append({
            "kind": "unknown", "score": 0.5,
            "evidence": {"burning": pressure}})

    diagnoses.sort(key=lambda d: (-d["score"], d["kind"]))
    return {
        "t": report.get("t"),
        "type": "explain",
        "schema_version": SCHEMA_VERSION,
        "report_schema": report.get("schema_version"),
        "window": report.get("window"),
        "pressure": pressure,
        "healthy": not pressure and not degraded,
        "primary": diagnoses[0]["kind"] if diagnoses else None,
        "diagnoses": diagnoses,
    }


def validate(record: dict) -> list:
    """Structural health of one explain record: the list of problems
    (empty = valid). Checks the contract the tuner/controller depend on:
    every diagnosis a known kind with a finite 0..1 score and an evidence
    dict, the list ranked by score, ``primary`` consistent with it, and
    ``unknown`` never stamped on a window the record itself calls
    healthy."""
    problems = []
    if not isinstance(record, dict) or record.get("type") != "explain":
        return [f"not an explain record: {type(record).__name__}"]
    if record.get("schema_version") != SCHEMA_VERSION:
        problems.append(f"schema_version {record.get('schema_version')!r} "
                        f"!= {SCHEMA_VERSION}")
    diags = record.get("diagnoses")
    if not isinstance(diags, list):
        return problems + ["diagnoses is not a list"]
    prev_score = None
    for i, d in enumerate(diags):
        label = f"diagnoses[{i}]"
        if not isinstance(d, dict):
            problems.append(f"{label} is not a record")
            continue
        kind = d.get("kind")
        if kind not in KINDS:
            problems.append(f"{label}.kind unknown: {kind!r}")
        score = d.get("score")
        if not (_finite(score) and 0.0 <= score <= 1.0):
            problems.append(f"{label}.score not in [0,1]: {score!r}")
        elif prev_score is not None and score > prev_score:
            problems.append(f"{label} not ranked (score {score} after "
                            f"{prev_score})")
        else:
            prev_score = score
        if not isinstance(d.get("evidence"), dict):
            problems.append(f"{label} carries no evidence")
    primary = record.get("primary")
    top = diags[0].get("kind") if diags and isinstance(diags[0], dict) \
        else None
    if primary != top:
        problems.append(f"primary {primary!r} != top diagnosis {top!r}")
    if record.get("healthy") and any(
            isinstance(d, dict) and d.get("kind") == "unknown"
            for d in diags):
        problems.append("unknown diagnosis on a healthy window")
    return problems
