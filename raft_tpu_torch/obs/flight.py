"""Fleet flight recorder (counterpart of ``raft_tpu/obs/flight.py``): the
time-and-fleet dimension of the obs stack.

* **Time** — :class:`FlightRecorder`, a pumpable/background windowed
  sampler (``RAFT_TPU_OBS_FLIGHT_INTERVAL_S``) that snapshots
  ``obs.report.collect()`` plus a **config fingerprint** (the knob vector:
  algo, nprobe, k, scan engine, page_rows, batch cap, tier census,
  process_count — :func:`fingerprint`) into a bounded ring and a
  crash-safe JSONL stream via ``bench/progress``. Each window also carries
  *window-local* operating-point deltas (``ops``: QPS and latency
  percentile bounds from counter/bucket differences between consecutive
  cumulative snapshots), the resilience events that landed since the last
  window (an induced shard loss shows up as a timeline event), and — on the
  first window — the device-health verdict of obs/health.py's probe (a
  bounded child process that runs one matmul on ``cuda``), so every
  recording opens self-documenting. Every provider degrades classified
  (the ``obs.flight.sample`` faultpoint is the injectable stand-in), so a
  broken plane costs one window's section, never the serving loop.

* **Fleet** — the straggler plane: the ``distributed.shard_skew`` gauge
  (max/median per-dispatch shard-time ratio, set by
  ``distributed/_sharding.probe_shards``) is folded into every window,
  and a ratio that stays hot for ``RAFT_TPU_OBS_STRAGGLER_WINDOWS``
  consecutive windows raises a classified ``straggler`` event plus the
  ``flight.straggler_events`` counter. Cross-host trace *stitching* lives
  in obs/aggregate.py (``stitch_traces``); this module contributes the
  per-process clock-offset handshake record that opens each recording
  (obs/tracing.clock_handshake) so the stitcher can align host clocks.

The frontier: :func:`extract_frontier` groups windows by fingerprint and
marks the Pareto-optimal operating points (maximize recall and QPS,
minimize p99 upper bound) — the dataset the autotuner
(tuning/autotune.py) consumes. :func:`fingerprint`'s hash is the JAX
package's for the same knobs and process count.

CLI::

    python -m raft_tpu_torch.obs.flight results/flight_*.jsonl            # summary
    python -m raft_tpu_torch.obs.flight rec.jsonl --validate              # gate
    python -m raft_tpu_torch.obs.flight rec.jsonl --render                # timeline
    python -m raft_tpu_torch.obs.flight rec.jsonl --frontier frontier.json

Telemetry-off contract: a disabled registry means the recorder holds ZERO
state — no ring, no providers, no clock reads; ``maybe_sample`` is one
attribute check. Like report/aggregate, this module is deliberately NOT
imported by ``obs/__init__`` (clean ``-m`` execution; the report import
would drag the SLO plane onto the package import path).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import sys
import threading
import time
from collections import deque
from typing import Optional

from raft_tpu_torch import obs, resilience
from raft_tpu_torch.obs import tracing

__all__ = [
    "FlightRecorder",
    "SCHEMA_VERSION",
    "extract_frontier",
    "fingerprint",
    "main",
    "read_recording",
    "render",
    "validate",
]

#: flight_window record schema (independent of obs.report's version — the
#: embedded report carries its own stamp)
SCHEMA_VERSION = 1

INTERVAL_ENV = "RAFT_TPU_OBS_FLIGHT_INTERVAL_S"
CAP_ENV = "RAFT_TPU_OBS_FLIGHT_CAP"
RATIO_ENV = "RAFT_TPU_OBS_STRAGGLER_RATIO"
WINDOWS_ENV = "RAFT_TPU_OBS_STRAGGLER_WINDOWS"

_DEFAULT_INTERVAL_S = 1.0
_DEFAULT_CAP = 256
_DEFAULT_RATIO = 4.0
_DEFAULT_WINDOWS = 2
_HEALTH_TIMEOUT_S = 10.0

#: the latency histogram / success counter the window-local ops derive from
_LAT_HIST = "serving.request_latency_s"
_OK_COUNTER = "serving.requests.ok"
_SKEW_GAUGE = "distributed.shard_skew"


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    try:
        v = float(raw) if raw else default
    except ValueError:
        return default
    return v if v > 0 else default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    return int(raw) if raw.isdigit() and int(raw) > 0 else default


def _classified(fn, label: str, out_errors: dict):
    """One provider; failure degrades its section to None, classified into
    ``errors`` — the report.py contract: a recorder must record, not raise."""
    try:
        return fn()
    except Exception as e:
        out_errors[label] = resilience.classify(e)
        return None


def fingerprint(knobs: dict) -> dict:
    """Canonical config fingerprint: the knob vector plus a short stable
    hash (``fp``) that keys frontier groups. ``process_count`` is stamped
    from the fleet identity so a scale-out is a DIFFERENT operating point
    even with identical per-host knobs. Values must be JSON-serializable;
    the hash is over the sorted canonical JSON, so dict ordering and float
    repr quirks cannot split one configuration into two groups."""
    _pi, pc = tracing.process_info()
    out = dict(knobs or {})
    out.setdefault("process_count", pc)
    blob = json.dumps(out, sort_keys=True, default=str)
    out["fp"] = hashlib.sha1(blob.encode()).hexdigest()[:12]
    return out


def _resolve(provider):
    """Providers may be live objects or zero-arg callables (a caller
    that rebuilds its queue per load window hands a closure)."""
    return provider() if callable(provider) else provider


class FlightRecorder:
    """Windowed operating-point sampler over the whole observability plane.

    Drive it by pumping (:meth:`maybe_sample` in a serving loop — one
    attribute check plus one clock read per call when the interval has not
    elapsed) or with the background thread (:meth:`start` / :meth:`stop`).
    ``path`` (optional) streams every window crash-safe through
    ``bench/progress.export_metrics``; the recording opens with the
    per-process clock-offset handshake record the trace stitcher consumes.

    Providers (``engine``/``sampler``/``queue``/``capacity``) are passed
    straight to ``obs.report.collect``; each may be a zero-arg callable.
    ``knobs`` (dict or callable) feeds :func:`fingerprint`. ``health`` is
    a precomputed device-health verdict for the first window; with
    ``probe_health=True`` the recorder runs the subprocess probe itself
    (classified on failure) — callers pay that cost once, on the first
    sample, so take window 0 off any measured clock.
    """

    def __init__(self, path: Optional[str] = None, *, knobs=None,
                 engine=None, sampler=None, queue=None, capacity=None,
                 health=None, probe_health: bool = False,
                 interval_s: Optional[float] = None,
                 cap: Optional[int] = None,
                 extra: Optional[dict] = None):
        self._enabled = obs.enabled()
        if not self._enabled:
            return  # telemetry off ⇒ ZERO flight state (the NOOP contract)
        self._path = path
        self._knobs = knobs
        self._engine = engine
        self._sampler = sampler
        self._queue = queue
        self._capacity = capacity
        self._health = health
        self._probe_health = bool(probe_health)
        self._extra = dict(extra) if extra else None
        self._interval_s = (float(interval_s) if interval_s is not None
                            else _env_float(INTERVAL_ENV,
                                            _DEFAULT_INTERVAL_S))
        self._ring: deque = deque(
            maxlen=cap if cap else _env_int(CAP_ENV, _DEFAULT_CAP))  # guarded-by: _lock
        self._ratio = _env_float(RATIO_ENV, _DEFAULT_RATIO)
        self._hot_needed = _env_int(WINDOWS_ENV, _DEFAULT_WINDOWS)
        self._hot = 0                  # guarded-by: _lock
        self._straggler_events = 0     # guarded-by: _lock
        self._window = 0               # guarded-by: _lock
        self._t_last: Optional[float] = None   # guarded-by: _lock
        self._prev_ops: Optional[dict] = None  # guarded-by: _lock
        self._last_event_t = 0.0       # guarded-by: _lock
        self._wrote_handshake = False  # guarded-by: _lock
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop_ev = threading.Event()

    # -- pump / background ---------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def windows_recorded(self) -> int:
        if not self._enabled:
            return 0
        with self._lock:
            return self._window

    @property
    def straggler_events(self) -> int:
        if not self._enabled:
            return 0
        with self._lock:
            return self._straggler_events

    def records(self) -> list:
        """Snapshot of the bounded window ring, oldest first."""
        if not self._enabled:
            return []
        with self._lock:
            return list(self._ring)

    def maybe_sample(self, now: Optional[float] = None) -> Optional[dict]:
        """Sample one window iff the interval elapsed; the pump entry for
        serving loops. Disabled or early: None, at one branch of cost."""
        if not self._enabled:
            return None
        now = time.monotonic() if now is None else now
        with self._lock:
            t_last = self._t_last
        if t_last is not None and now - t_last < self._interval_s:
            return None
        return self.sample(now=now)

    def start(self) -> None:
        """Background mode: a daemon thread pumps at a quarter interval."""
        if not self._enabled or self._thread is not None:
            return
        self._stop_ev.clear()
        t = threading.Thread(target=self._run, name="flight-recorder",
                             daemon=True)
        self._thread = t
        t.start()

    def stop(self) -> None:
        if not self._enabled or self._thread is None:
            return
        self._stop_ev.set()
        self._thread.join(timeout=10.0)
        self._thread = None

    def _run(self) -> None:
        tick = max(self._interval_s / 4.0, 0.01)
        while not self._stop_ev.wait(tick):
            self.sample_safe()

    def sample_safe(self) -> Optional[dict]:
        """:meth:`maybe_sample` that classifies instead of raising — the
        background thread's entry (an exception there would die silent)."""
        if not self._enabled:
            return None
        try:
            return self.maybe_sample()
        except Exception as e:
            resilience.classify(e)
            obs.add("flight.sample_degraded")
            return None

    # -- sampling ------------------------------------------------------------
    def sample(self, now: Optional[float] = None) -> Optional[dict]:
        """Record one window NOW (forced — callers close a load window with
        this regardless of the interval). Every provider degrades
        classified; an armed ``obs.flight.sample`` fault degrades the whole
        window to a classified stub, and the NEXT sample recovers."""
        if not self._enabled:
            return None
        with self._lock:
            with obs.record_span("obs.flight::sample",
                                 attrs={"window": self._window}):
                return self._sample_locked(
                    time.monotonic() if now is None else now)

    def _sample_locked(self, t_mono: float) -> dict:
        errors: dict = {}
        rec = {
            "t": round(time.time(), 3),
            "type": "flight_window",
            "schema_version": SCHEMA_VERSION,
            "window": self._window,
            "interval_s": (round(t_mono - self._t_last, 4)
                           if self._t_last is not None else 0.0),
        }
        try:
            resilience.faultpoint("obs.flight.sample")
            snap = _classified(obs.snapshot, "snapshot", errors) or {}
            rec["fingerprint"] = _classified(
                lambda: fingerprint(_resolve(self._knobs) or {}),
                "fingerprint", errors)
            rec["report"] = _classified(
                lambda: self._report(snap), "report", errors)
            ops = _classified(
                lambda: self._ops(snap, rec["interval_s"]), "ops", errors)
            rec["ops"] = ops if ops is not None else {}
            rec["events"] = _classified(
                lambda: self._new_events(), "events", errors) or []
            if self._window == 0:
                rec["health"] = _classified(
                    lambda: self._health_verdict(), "health", errors)
            self._straggler_check(rec)
        except Exception as e:
            # the armed-faultpoint path (and any residue the per-provider
            # guards cannot see): the window survives as a classified stub
            errors["sample"] = resilience.classify(e)
            obs.add("flight.sample_degraded")
        if errors:
            rec["errors"] = errors
        if self._extra:
            rec.update(self._extra)
        self._window += 1
        self._t_last = t_mono
        self._ring.append(rec)
        export_errors: dict = {}
        _classified(lambda: self._export(rec), "export", export_errors)
        if export_errors:
            # the ring still holds the window; a dead stream (read-only fs)
            # costs durability, classified, never the serving loop
            obs.add("flight.export_degraded")
        return rec

    def _report(self, snap: dict) -> dict:
        # lazy: report drags the SLO plane; a pumping process that never
        # samples (telemetry off upstream) must not pay the import
        from raft_tpu_torch.obs import report as obs_report

        return obs_report.collect(
            engine=_resolve(self._engine), sampler=_resolve(self._sampler),
            queue=_resolve(self._queue), capacity=_resolve(self._capacity),
            snapshot=snap, window=self._window)

    def _ops(self, snap: dict, dt: float) -> dict:
        """Window-LOCAL operating point: deltas between this and the
        previous cumulative snapshot — counters subtract, histogram buckets
        subtract key-wise and re-derive percentile bounds over just this
        window's observations."""
        from raft_tpu_torch.obs import aggregate

        counters = snap.get("counters") or {}
        hist = (snap.get("histograms") or {}).get(_LAT_HIST) or {}
        prev = self._prev_ops or {}
        ok = int(counters.get(_OK_COUNTER, 0))
        d_ok = ok - prev.get("ok", 0)
        ops = {"requests_ok": d_ok}
        if dt > 0:
            ops["qps"] = round(d_ok / dt, 2)
        prev_b = prev.get("buckets") or {}
        buckets = dict(hist.get("buckets") or {})
        d_buckets = {key: n - prev_b.get(key, 0)
                     for key, n in buckets.items()
                     if n - prev_b.get(key, 0) > 0}
        d_count = int(hist.get("count", 0)) - prev.get("count", 0)
        if d_count > 0:
            pb = aggregate.percentile_bounds(d_buckets, d_count)
            if pb:
                ops["p50_ub_s"] = pb["p50_ub"]
                ops["p99_ub_s"] = pb["p99_ub"]
        skew = ((snap.get("gauges") or {}).get(_SKEW_GAUGE) or {}).get("value")
        if skew is not None:
            ops["shard_skew"] = round(float(skew), 3)
        self._prev_ops = {"ok": ok, "buckets": buckets,
                          "count": int(hist.get("count", 0))}
        return ops

    def _new_events(self) -> list:
        """Resilience events that landed since the last window — how an
        induced shard loss (partial_merge) shows as a TIMELINE event."""
        fresh = [dict(e) for e in resilience.recent_events()
                 if e.get("t", 0) > self._last_event_t]
        if fresh:
            self._last_event_t = max(e.get("t", 0) for e in fresh)
        return fresh

    def _health_verdict(self) -> Optional[dict]:
        if self._health is not None:
            h = self._health
            return h.as_dict() if hasattr(h, "as_dict") else dict(h)
        if not self._probe_health:
            return None
        from raft_tpu_torch.obs import health as obs_health

        return obs_health.probe("default",
                                timeout=_HEALTH_TIMEOUT_S).as_dict()

    def _straggler_check(self, rec: dict) -> None:
        """A shard-skew ratio hot for N consecutive windows is a straggler:
        one classified event per sustained excursion, then re-arm."""
        skew = (rec.get("ops") or {}).get("shard_skew")
        if skew is not None and skew >= self._ratio:
            self._hot += 1
        else:
            self._hot = 0
        if self._hot >= self._hot_needed:
            self._straggler_events += 1
            obs.add("flight.straggler_events")
            resilience.record_event(
                "straggler", site="obs.flight", skew=skew,
                windows=self._hot, ratio=self._ratio)
            rec["straggler"] = {"skew": skew, "windows": self._hot,
                                "ratio": self._ratio}
            self._hot = 0
        rec["straggler_events"] = self._straggler_events

    def _export(self, rec: dict) -> None:
        if not self._path:
            return
        # bench/progress: the one fsync'd JSONL writer (crash-safety
        # contract) — stdlib-only, no import cycle
        from raft_tpu_torch.bench import progress

        if not self._wrote_handshake:
            self._wrote_handshake = True
            progress.export_metrics(self._path, tracing.clock_handshake())
        progress.export_metrics(self._path, rec)


# ---------------------------------------------------------------------------
# recording analysis: read / validate / frontier / render
# ---------------------------------------------------------------------------


def read_recording(path: str) -> list:
    """Parse one flight JSONL recording, skipping torn/corrupt lines (the
    bench/progress read tolerance). Returns ALL records — flight_window
    lines plus the opening clock_offset handshake."""
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
                    records.append(rec)
    except OSError:
        return []
    return records


def _windows(records: list) -> list:
    return [r for r in records if r.get("type") == "flight_window"]


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


_KNOWN_KINDS = {resilience.OOM, resilience.TRANSIENT, resilience.DEADLINE,
                resilience.FATAL}


def validate(records: list) -> list:
    """Structural health of one recording: the list of problems (empty =
    valid). A degraded window (classified ``errors``) is VALID — that is
    the recorder doing its job — but unclassified degradation, non-
    monotonic window ids, a missing handshake or a missing opening health
    verdict are not."""
    problems = []
    wins = _windows(records)
    if not wins:
        problems.append("no flight_window records")
        return problems
    if not any(r.get("type") == "clock_offset" for r in records):
        problems.append("recording carries no clock_offset handshake")
    last_by_proc: dict = {}
    for rec in wins:
        w = rec.get("window")
        label = f"window {w!r}"
        if not isinstance(w, int) or w < 0:
            problems.append(f"{label}: bad window id")
            continue
        if rec.get("schema_version") != SCHEMA_VERSION:
            problems.append(f"{label}: schema_version "
                            f"{rec.get('schema_version')!r} != "
                            f"{SCHEMA_VERSION}")
        pi = rec.get("process_index", 0)
        prev = last_by_proc.get(pi)
        if prev is not None and w <= prev:
            problems.append(f"{label}: window id not increasing for "
                            f"process {pi} (prev {prev})")
        last_by_proc[pi] = w
        if not _finite(rec.get("interval_s")) or rec["interval_s"] < 0:
            problems.append(f"{label}: interval_s not finite")
        errors = rec.get("errors") or {}
        for section, kind in errors.items():
            if kind not in _KNOWN_KINDS:
                problems.append(f"{label}: unclassified degradation "
                                f"{section}={kind!r}")
        degraded = "sample" in errors
        if not degraded:
            fp = rec.get("fingerprint")
            if "fingerprint" not in errors and (
                    not isinstance(fp, dict) or not fp.get("fp")):
                problems.append(f"{label}: fingerprint missing its fp hash")
            if "ops" not in errors and not isinstance(rec.get("ops"), dict):
                problems.append(f"{label}: ops section missing")
            if w == 0 and "health" not in rec and "health" not in errors:
                problems.append("window 0 carries no device-health verdict")
    return problems


def extract_frontier(records: list) -> dict:
    """Group windows by config fingerprint and mark the Pareto frontier
    over (recall ± CI up, QPS up, p99 upper bound down). Missing axes
    compare as worst-possible but equal-to-each-other, so a recording
    with no recall plane still yields a QPS/p99 frontier — and at least
    one point is always non-dominated when any group exists."""
    with obs.record_span("obs.flight::frontier"):
        groups: dict = {}
        for rec in _windows(records):
            fp_rec = rec.get("fingerprint")
            if not isinstance(fp_rec, dict) or not fp_rec.get("fp"):
                continue
            fp = fp_rec["fp"]
            g = groups.setdefault(fp, {
                "fp": fp,
                "knobs": {k: v for k, v in fp_rec.items() if k != "fp"},
                "windows": 0, "_qps": [], "_p99": [], "recall": None,
            })
            g["windows"] += 1
            ops = rec.get("ops") or {}
            if _finite(ops.get("qps")) and ops["qps"] > 0:
                g["_qps"].append(float(ops["qps"]))
            if _finite(ops.get("p99_ub_s")):
                g["_p99"].append(float(ops["p99_ub_s"]))
            recall = ((rec.get("report") or {}).get("recall")
                      if isinstance(rec.get("report"), dict) else None)
            if isinstance(recall, dict) and _finite(recall.get("recall")):
                # cumulative estimate: the newest window's value wins
                g["recall"] = recall["recall"]
                g["recall_ci_low"] = recall.get("ci_low")
                g["recall_ci_high"] = recall.get("ci_high")
        points = []
        for g in groups.values():
            qps = sorted(g.pop("_qps"))
            p99 = sorted(g.pop("_p99"))
            g["qps"] = qps[len(qps) // 2] if qps else None
            g["p99_ub_s"] = p99[len(p99) // 2] if p99 else None
            points.append(g)

        def axes(pt):
            return (pt["recall"] if _finite(pt["recall"]) else -math.inf,
                    pt["qps"] if _finite(pt["qps"]) else -math.inf,
                    -pt["p99_ub_s"] if _finite(pt["p99_ub_s"]) else -math.inf)

        for pt in points:
            a = axes(pt)
            pt["pareto"] = not any(
                all(bj >= aj for aj, bj in zip(a, axes(other)))
                and any(bj > aj for aj, bj in zip(a, axes(other)))
                for other in points if other is not pt)
        points.sort(key=lambda p: (not p["pareto"],
                                   -(p["qps"] or 0.0), p["fp"]))
        return {
            "type": "flight_frontier",
            "schema_version": SCHEMA_VERSION,
            "points": len(points),
            "pareto_points": sum(1 for p in points if p["pareto"]),
            "groups": points,
        }


def render(records: list) -> str:
    """Human-readable timeline: one line per window — elapsed offset,
    fingerprint, window-local QPS/p99/skew, event and degradation notes."""
    with obs.record_span("obs.flight::render"):
        wins = _windows(records)
        if not wins:
            return "(empty recording)"
        t0 = wins[0].get("t", 0.0)
        lines = []
        for rec in wins:
            ops = rec.get("ops") or {}
            bits = [f"w{rec.get('window', '?'):>3}",
                    f"t=+{max(0.0, rec.get('t', t0) - t0):.2f}s",
                    f"fp={(rec.get('fingerprint') or {}).get('fp', '-')}"]
            if ops.get("qps") is not None:
                bits.append(f"qps={ops['qps']:g}")
            if ops.get("p99_ub_s") is not None:
                bits.append(f"p99<={ops['p99_ub_s']:g}s")
            if ops.get("shard_skew") is not None:
                bits.append(f"skew={ops['shard_skew']:g}")
            events = rec.get("events") or []
            if events:
                names = sorted({e.get("event", "?") for e in events})
                bits.append(f"events={len(events)}({','.join(names)})")
            if "straggler" in rec:
                bits.append("STRAGGLER")
            if rec.get("errors"):
                bits.append("degraded=" + ",".join(
                    f"{k}:{v}" for k, v in sorted(rec["errors"].items())))
            if "health" in rec:
                h = rec.get("health")
                verdict = (h or {}).get("healthy") if isinstance(h, dict) \
                    else None
                bits.append(f"health={'ok' if verdict else verdict}")
            lines.append("  ".join(bits))
        return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.obs.flight",
        description="Validate, render and mine flight recordings: the "
                    "continuous operating-point timeline a serving loop "
                    "streams, and the Pareto frontier (recall vs p99 vs "
                    "QPS, grouped by config fingerprint) the autotuner "
                    "consumes.")
    ap.add_argument("files", nargs="+", help="flight JSONL recording(s)")
    ap.add_argument("--validate", action="store_true",
                    help="exit 1 unless every recording passes validate()")
    ap.add_argument("--render", action="store_true",
                    help="print the window-by-window timeline")
    ap.add_argument("--frontier", nargs="?", const="frontier.json",
                    default=None, metavar="PATH",
                    help="extract the Pareto frontier to PATH (default "
                         "frontier.json); exit 1 if it comes out empty")
    ap.add_argument("--indent", type=int, default=2)
    args = ap.parse_args(argv)

    all_records = []
    rc = 0
    for path in args.files:
        records = read_recording(path)
        if not _windows(records):
            print(f"flight: no flight_window records in {path}",
                  file=sys.stderr)
            return 2
        all_records.extend(records)
        if args.validate:
            problems = validate(records)
            if problems:
                for p in problems:
                    print(f"flight: INVALID: {path}: {p}", file=sys.stderr)
                rc = 1
            else:
                print(f"flight: valid: {path} "
                      f"({len(_windows(records))} windows)", file=sys.stderr)
    if args.render:
        print(render(all_records))
    frontier = extract_frontier(all_records)
    if args.frontier:
        with open(args.frontier, "w") as f:
            json.dump(frontier, f, indent=args.indent, sort_keys=True)
            f.write("\n")
            f.flush()
        if not frontier["pareto_points"]:
            print("flight: frontier EMPTY (no fingerprinted windows)",
                  file=sys.stderr)
            return 1
    wins = _windows(all_records)
    stragglers = sum(1 for r in wins if "straggler" in r)
    print(f"flight: {len(wins)} windows, "
          f"{frontier['points']} fingerprint group(s), "
          f"{frontier['pareto_points']} on the frontier, "
          f"{stragglers} straggler window(s)")
    return rc


if __name__ == "__main__":
    sys.exit(main())
