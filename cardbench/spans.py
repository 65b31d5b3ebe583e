"""The port's own spans and counters over a traced search window, reduced
to the per-layer readings they feed.

With telemetry on (``obs.enable()``, a ring that holds every span of the
window), a window of ``ivf_pq.search`` calls leaves the registry's
per-name span totals (host ``total_s`` and card ``device_total_s``, exact
whatever the ring holds), its counters (after ``registry.settle()``) and
the span records, whose ``t0``/``dur_s`` sit on the profiler's epoch
clock. This module reduces them:

* :func:`phase_ms` — device ms a request in each phase of the search
  (:data:`PHASES`);
* :func:`useful_share` — K1's useful share of the products it computes;
* :func:`idle_by_span` — device-idle seconds by the innermost port span
  open at each gap, the rest under :data:`OUTSIDE`, and
  :func:`port_idle_ms` from it;
* :func:`clock_check` — each ``ivf_pq::search`` record against the
  profiler range of the same name;
* :func:`events_by_kind` — the profiler's raw events split into device
  work, the window and host ranges by name.

The traced branch of ``loops/search_closed.py`` and ``trace.Trace`` do not
call these yet; ``scripts/search_spans.py`` runs a cell's window with
them.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from cardbench.trace import (DEVICE_WORK, WINDOW_LABEL, _interval, _is_device,
                             union_seconds)

#: the phase spans of ``ivf_pq.search``, read together by what they feed
PHASES = {
    "prep_ms": ("ivf_pq::probe_select", "ivf_pq::bias"),
    "plan_ms": ("strip_scan::plan", "strip_scan::group"),
    "class_ms": ("strip_scan::class",),
    "merge_ms": ("strip_scan::merge", "ivf_pq::finalize"),
}
#: the span every request opens
SEARCH = "ivf_pq::search"
#: idle with no port span open
OUTSIDE = "outside the port"


def events_by_kind(events):
    """(device work intervals, the window's interval, host ranges by name)
    from the profiler's raw events, each on its epoch-nanosecond clock.
    Where the events carry no activity type, the device's copies of host
    ranges (the spans' profiler ranges among them) are told from its work
    by name, as :func:`cardbench.trace.reduce_events` does."""
    dev, ranges, window = [], defaultdict(list), None
    typed = None
    for ev in events:
        if typed is None:
            typed = hasattr(ev, "activity_type")
        if _is_device(ev):
            if not typed or ev.activity_type() in DEVICE_WORK:
                dev.append(_interval(ev) + (ev.name(),))
        elif ev.name() == WINDOW_LABEL:
            window = _interval(ev)
        else:
            ranges[ev.name()].append(_interval(ev))
    if not typed:
        dev = [d for d in dev if d[2] not in ranges and d[2] != WINDOW_LABEL]
    return [(s, e) for s, e, _ in dev], window, ranges


def phase_ms(timers: dict, n_search: int) -> Dict[str, float]:
    """Device ms a request in each phase, from the per-name totals."""
    return {key: 1e3 * sum(timers.get(n, {}).get("device_total_s", 0.0)
                           for n in names) / n_search
            for key, names in PHASES.items()}


def useful_share(counters: dict) -> Optional[float]:
    """100 × ``strip_scan.k1.products_needed`` / ``products_computed``, or
    None where K1 computed nothing."""
    comp = counters.get("strip_scan.k1.products_computed")
    if not comp:
        return None
    return 100.0 * counters.get("strip_scan.k1.products_needed", 0) / comp


def idle_by_span(gaps, records) -> Dict[str, float]:
    """Idle seconds by the innermost port span open at each gap's midpoint
    (the latest-starting record that holds it), the rest under
    :data:`OUTSIDE`. ``gaps`` (epoch ns) and the records' ``t0``/``dur_s``
    (epoch s) are on one clock."""
    spans = sorted((int(r["t0"] * 1e9), int((r["t0"] + r["dur_s"]) * 1e9),
                    r["name"]) for r in records)
    out: Dict[str, float] = defaultdict(float)
    active, i = [], 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        while i < len(spans) and spans[i][0] <= mid:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] >= mid]
        out[max(active)[2] if active else OUTSIDE] += (g1 - g0) * 1e-9
    return dict(out)


def window_gaps(dev: List[Tuple[int, int]],
                window: Tuple[int, int]) -> List[Tuple[int, int]]:
    """The window's device-idle intervals: before its first work, between
    works, after its last."""
    _, gaps = union_seconds(dev)
    first = min(s for s, _ in dev)
    last = max(e for _, e in dev)
    return [(window[0], first)] + gaps + [(last, window[1])]


def port_idle_ms(records, n_search: int, dev, window) -> Optional[dict]:
    """(device-idle ms a request inside a port span, idle seconds by span),
    or None unless the records hold every request's span (a ring that
    dropped any gives no number, never a partial one)."""
    if window is None or not dev or sum(
            1 for r in records if r["name"] == SEARCH) != n_search:
        return None
    by_span = idle_by_span(window_gaps(dev, window), records)
    inside = sum(by_span.values()) - by_span.get(OUTSIDE, 0.0)
    return {"port_idle_ms": 1e3 * inside / n_search, "idle_by_span_s": dict(
        sorted(by_span.items(), key=lambda kv: -kv[1]))}


def clock_check(records, ranges) -> dict:
    """Each ``ivf_pq::search`` record against the profiler range of the
    same name that holds its start: how many lie inside, and the distance
    from a record's end to its range's end (µs): the widest, and how many
    exceed 50 µs."""
    rs = sorted(ranges.get(SEARCH, []))
    gaps, n = [], 0
    for r in records:
        if r["name"] != SEARCH:
            continue
        n += 1
        s0 = int(r["t0"] * 1e9)
        s1 = s0 + int(r["dur_s"] * 1e9)
        hold = [g for g in rs if g[0] <= s0 <= g[1]]
        if hold and s1 <= hold[0][1]:
            gaps.append((hold[0][1] - s1) * 1e-3)
    return {"records": n, "inside": len(gaps),
            "widest_end_gap_us": max(gaps, default=0.0),
            "over_50us": sum(g > 50 for g in gaps)}


def reduce_spans(snap: dict, records, search_ms: float, dev,
                 window) -> dict:
    """Every reading of a window: :func:`phase_ms`, their coverage of the
    CUDA-event ``search_ms``, the device and host ms of ``ivf_pq::search``
    and ``refine::refine``, :func:`useful_share`, :func:`port_idle_ms`."""
    timers, counters = snap["timers"], snap["counters"]
    n_search = timers[SEARCH]["count"]
    out: dict = dict(phase_ms(timers, n_search))
    covered = sum(out[k] for k in PHASES)
    out["covered_ms"] = covered
    out["coverage"] = covered / search_ms if search_ms else None
    for key, name in (("search", SEARCH), ("refine", "refine::refine")):
        t = timers.get(name, {})
        out[f"{key}_device_ms"] = 1e3 * t.get("device_total_s", 0.0) / \
            n_search
        out[f"{key}_host_ms"] = 1e3 * t.get("total_s", 0.0) / n_search
    out["k1_useful_share"] = useful_share(counters)
    live = counters.get("strip_scan.slots.live")
    launched = counters.get("strip_scan.slots.launched")
    out["slot_share"] = 100.0 * live / launched if launched else None
    out["counters"] = {k: v for k, v in counters.items()
                       if k.startswith(("strip_scan.", "ivf_pq.search."))}
    out["spans_by_name"] = {
        k: {"count": v["count"], "host_s": v["total_s"],
            "device_s": v.get("device_total_s")}
        for k, v in timers.items()}
    out["ring_complete"] = sum(
        1 for r in records if r["name"] == SEARCH) == n_search
    out.update(port_idle_ms(records, n_search, dev, window) or {})
    return out
