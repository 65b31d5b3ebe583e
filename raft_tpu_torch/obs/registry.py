"""Process-wide metrics registry (counterpart of
``raft_tpu/obs/registry.py``): counters, wall-clock timers, pow2
histograms, gauges, and the span that feeds them.

Every :func:`record_span` feeds both the profiler timeline
(``torch.profiler.record_function``, plus an NVTX range once a CUDA
context exists) and this registry, so hot-path timings survive the process
even when no profiler capture is active. Telemetry is OFF by default: the
gate is ``RAFT_TPU_OBS`` (or :func:`enable` / :func:`disable`), and every
instrumented site guards its emission with ``if obs.enabled():``, so the
disabled cost is one branch. When disabled, :func:`record_span` returns
the shared no-op :data:`NOOP_SPAN` and never touches the registry.

Span timings are host wall clock around the instrumented region. CUDA
work is queued asynchronously, so a span measures the enqueue unless sync
mode (``RAFT_TPU_OBS_SYNC=1``) drains the cards at its exit.
"""

from __future__ import annotations

import json
import math
import os
import sys
import threading
import time
from collections import deque
from typing import Optional

from raft_tpu_torch.obs import tracing as _tracing
from raft_tpu_torch.obs.aggregate import percentile_bounds

__all__ = [
    "DISPATCH_HIST_PREFIX",
    "EXEMPLAR_CAP",
    "MetricsRegistry",
    "NOOP_SPAN",
    "add",
    "disable",
    "enable",
    "enabled",
    "export_jsonl",
    "inc_gauge",
    "observe",
    "record_span",
    "record_timing",
    "register_dispatch_span",
    "registry",
    "reset",
    "set_gauge",
    "snapshot",
]

#: exemplars kept per histogram (newest win): enough to link each
#: percentile bucket of a latency histogram to a recent trace id
EXEMPLAR_CAP = 8

#: histogram namespace of sync-mode committed span durations:
#: ``dispatch.<span name>``, the measured leg obs/roofline pairs with its
#: static FLOP/byte model
DISPATCH_HIST_PREFIX = "dispatch."

#: spans whose sync-mode committed durations fold into a ``dispatch.*``
#: histogram — only registered device-dispatch spans (obs/roofline
#: registers its entries' spans at import), so host spans are never
#: labelled as device dispatches
_DISPATCH_SPANS: set = set()


def register_dispatch_span(name: str) -> None:
    """Opt a span name into the sync-mode ``dispatch.*`` histogram fold."""
    _DISPATCH_SPANS.add(name)


_enabled = os.environ.get("RAFT_TPU_OBS", "").strip().lower() in (
    "1", "true", "on", "yes",
)


def enabled() -> bool:
    """The single-branch hot-path gate: instrumented code runs its emission
    only under ``if obs.enabled():``."""
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


class _TimerStat:
    """count / total / min / max of one named wall-clock timer."""

    __slots__ = ("count", "total_s", "min_s", "max_s")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.min_s = math.inf
        self.max_s = 0.0

    def add(self, seconds: float) -> None:
        self.count += 1
        self.total_s += seconds
        if seconds < self.min_s:
            self.min_s = seconds
        if seconds > self.max_s:
            self.max_s = seconds

    def as_dict(self) -> dict:
        return {
            "count": self.count,
            "total_s": self.total_s,
            "min_s": self.min_s,
            "max_s": self.max_s,
            "mean_s": self.total_s / self.count if self.count else 0.0,
        }


class _HistStat:
    """Power-of-two-bucketed histogram (+ count/sum/min/max exact).

    Carries a small bounded **exemplar ring**: when an observation lands
    while a trace is open (or the caller passes ``trace_id`` explicitly),
    the ``(bucket, trace_id, value)`` triple is kept so a percentile bucket
    in a snapshot links back to a concrete recent trace — "p99 is 80 ms,
    and HERE is a request that paid it". The ring is ``EXEMPLAR_CAP`` deep
    (newest win) and dies with ``reset()``, so trace ids never leak across
    tests or runs."""

    __slots__ = ("count", "sum", "min", "max", "buckets", "exemplars")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: dict = {}
        self.exemplars: deque = deque(maxlen=EXEMPLAR_CAP)

    def add(self, value: float, trace_id: Optional[str] = None) -> None:
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        # bucket upper bound = smallest power of two >= value (0 for v <= 0).
        # repr, not %g: 6-sig-digit rounding would print 2**21 as
        # 'le_2.09715e+06', and the percentile parser reading that back
        # would report an "upper bound" BELOW the observed max
        bound = 0.0 if value <= 0 else 2.0 ** math.ceil(math.log2(value))
        key = f"le_{bound!r}"
        self.buckets[key] = self.buckets.get(key, 0) + 1
        if trace_id is not None:
            self.exemplars.append(
                {"bucket": key, "trace_id": trace_id, "value": value})

    def as_dict(self) -> dict:
        out = {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "buckets": dict(self.buckets),
        }
        if self.exemplars:
            out["exemplars"] = list(self.exemplars)
        # p50/p90/p99 UPPER bounds from the power-of-two buckets:
        # over-estimates the true quantile by ≤2× (the bucket resolution)
        out.update(percentile_bounds(self.buckets, self.count))
        return out


class _GaugeStat:
    """Last-value gauge with exact min/max/count of everything set."""

    __slots__ = ("value", "min", "max", "count")

    def __init__(self):
        self.value = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.count = 0

    def set(self, value: float) -> None:
        self.value = value
        self.count += 1
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def inc(self, delta: float) -> None:
        self.set(self.value + delta)

    def as_dict(self, process_key: str) -> dict:
        # "last" keys the final value by process, so snapshots of several
        # processes merge without losing any process's last value
        return {"value": self.value, "min": self.min, "max": self.max,
                "count": self.count, "last": {process_key: self.value}}


class MetricsRegistry:
    """Thread-safe named counters + timers + histograms with dict snapshots
    and JSONL export. One process-wide default instance lives in this module
    (:func:`registry`); algorithms never construct their own."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}  # guarded-by: _lock
        self._timers: dict = {}    # guarded-by: _lock
        self._hists: dict = {}     # guarded-by: _lock
        self._gauges: dict = {}    # guarded-by: _lock

    # -- writes -------------------------------------------------------------
    def add(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def record_timing(self, name: str, seconds: float) -> None:
        with self._lock:
            stat = self._timers.get(name)
            if stat is None:
                stat = self._timers[name] = _TimerStat()
            stat.add(seconds)

    def observe(self, name: str, value: float,
                trace_id: Optional[str] = None) -> None:
        """Record one histogram observation. ``trace_id`` (or, when None,
        the innermost open span's trace) lands in the histogram's exemplar
        ring so percentile buckets link to concrete recent traces."""
        if trace_id is None:
            cur = _tracing.current_span()
            if cur is not None:
                trace_id = cur[0]
        with self._lock:
            stat = self._hists.get(name)
            if stat is None:
                stat = self._hists[name] = _HistStat()
            stat.add(value, trace_id)

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            stat = self._gauges.get(name)
            if stat is None:
                stat = self._gauges[name] = _GaugeStat()
            stat.set(float(value))

    def inc_gauge(self, name: str, delta: float = 1) -> None:
        with self._lock:
            stat = self._gauges.get(name)
            if stat is None:
                stat = self._gauges[name] = _GaugeStat()
            stat.inc(float(delta))

    # -- reads --------------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain-dict copy: {"counters": .., "timers": .., "histograms": ..,
        "gauges": ..}. Empty sections are included so consumers need no key
        checks."""
        pk = f"p{_tracing.process_info()[0]}"
        with self._lock:
            return {
                "counters": dict(self._counters),
                "timers": {k: v.as_dict() for k, v in self._timers.items()},
                "histograms": {k: v.as_dict() for k, v in self._hists.items()},
                "gauges": {k: v.as_dict(pk) for k, v in self._gauges.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timers.clear()
            self._hists.clear()
            self._gauges.clear()

    def export_jsonl(self, path, extra: Optional[dict] = None) -> dict:
        """Append one timestamped snapshot line to ``path``; returns the
        record written. ``extra`` keys ride at the top level (run ids, phase
        tags). Every record is stamped with ``process_index`` /
        ``process_count`` (obs/tracing.process_info)."""
        pi, pc = _tracing.process_info()
        rec = {"t": round(time.time(), 3), "process_index": pi,
               "process_count": pc, **(extra or {}), **self.snapshot()}
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
        return rec


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


class _Annotation:
    """The span's mark on the profiler timeline: a
    ``torch.profiler.record_function`` range, and an NVTX range when a CUDA
    context already exists (never creating one)."""

    __slots__ = ("_rf", "_nvtx")

    def __init__(self, name: str):
        import torch

        self._rf = torch.profiler.record_function(name)
        self._nvtx = torch.cuda.is_initialized()
        self._rf.__enter__()
        if self._nvtx:
            torch.cuda.nvtx.range_push(name)

    def close(self, exc_type, exc, tb) -> None:
        if self._nvtx:
            sys.modules["torch"].cuda.nvtx.range_pop()
        self._rf.__exit__(exc_type, exc, tb)


def _classify_error(exc) -> str:
    """Failure kind of a span that raised, via resilience.classify (a lazy
    import: resilience imports obs)."""
    from raft_tpu_torch.resilience.errors import classify

    return classify(exc)


class _Span:
    """Context manager: profiler annotation + registry wall clock + one
    node of the span tree (obs/tracing.py).

    A body that raises still records its duration, and the span (plus a
    ``span.errors.{kind}`` counter) carries the ``resilience.classify()``
    kind of the failure. Under sync mode the cards are drained at exit so
    ``dur_s`` is committed time, with the enqueue wall clock kept as the
    ``dispatch_s`` attribute."""

    __slots__ = ("_name", "_reg", "_t0", "_t0_epoch", "_ann", "_attrs",
                 "_ids", "_token")

    def __init__(self, name: str, reg: MetricsRegistry,
                 attrs: Optional[dict] = None):
        self._name = name
        self._reg = reg
        self._attrs = attrs

    def set_attr(self, key: str, value):
        """Attach one typed attribute to the span record; chainable."""
        if self._attrs is None:
            self._attrs = {}
        self._attrs[key] = value
        return self

    def __enter__(self):
        self._ann = _Annotation(self._name)
        self._ids, self._token = _tracing.enter_span()
        self._t0_epoch = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        dispatch_s = None
        if exc_type is None and _tracing.sync_enabled() and \
                _tracing.drain_device():
            # the body's wall clock measured the enqueue; the cards drained,
            # so re-read: dur_s is committed time. No drain (no CUDA
            # context) records no dispatch_s
            dispatch_s = dt
            dt = time.perf_counter() - self._t0
        self._ann.close(exc_type, exc, tb)
        error = None
        if exc is not None:
            error = _classify_error(exc)
            self._reg.add(f"span.errors.{error}")
        self._reg.record_timing(self._name, dt)
        if dispatch_s is not None and self._name in _DISPATCH_SPANS:
            # committed duration of a registered dispatch span, exemplar-
            # linked to this span's trace
            self._reg.observe(f"{DISPATCH_HIST_PREFIX}{self._name}", dt,
                              trace_id=self._ids[0])
        _tracing.exit_span(self._ids, self._token, name=self._name,
                           t0=self._t0_epoch, dur_s=dt, attrs=self._attrs,
                           error=error, dispatch_s=dispatch_s)
        return False


class _NoopSpan:
    """Shared do-nothing span handed out whenever telemetry is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set_attr(self, key, value):
        return self


NOOP_SPAN = _NoopSpan()

_default = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _default


def record_span(name: str, reg: Optional[MetricsRegistry] = None,
                attrs: Optional[dict] = None):
    """``with obs.record_span("ivf_pq::search"): ...`` — times the block
    into the registry, marks it on the profiler timeline and records one
    node of the span tree, parented on the enclosing span. ``attrs``
    attaches typed attributes; build the dict inside an ``if
    obs.enabled():`` block so the off path allocates nothing. Disabled:
    the shared :data:`NOOP_SPAN`."""
    if not _enabled:
        return NOOP_SPAN
    return _Span(name, reg if reg is not None else _default, attrs)


def add(name: str, value: float = 1) -> None:
    if _enabled:
        _default.add(name, value)


def record_timing(name: str, seconds: float) -> None:
    if _enabled:
        _default.record_timing(name, seconds)


def observe(name: str, value: float, trace_id: Optional[str] = None) -> None:
    if _enabled:
        _default.observe(name, value, trace_id)


def set_gauge(name: str, value: float) -> None:
    """Set a last-value gauge; snapshots carry the last value and the exact
    min/max/count."""
    if _enabled:
        _default.set_gauge(name, value)


def inc_gauge(name: str, delta: float = 1) -> None:
    """Adjust a gauge relative to its current value."""
    if _enabled:
        _default.inc_gauge(name, delta)


def snapshot() -> dict:
    return _default.snapshot()


def reset() -> None:
    _default.reset()


def export_jsonl(path, extra: Optional[dict] = None) -> dict:
    return _default.export_jsonl(path, extra)
