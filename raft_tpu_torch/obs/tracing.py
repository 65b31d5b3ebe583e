"""Hierarchical span trees (counterpart of ``raft_tpu/obs/tracing.py``):
contextvar parenting, a bounded ring, Chrome trace export.

* **Parenting** is a :mod:`contextvars` variable, so nesting follows the
  call stack (threads and ``contextvars.copy_context`` tasks each get their
  own lineage; a span opened on a fresh thread starts a new trace).
* **Identity** is ``(trace_id, span_id, parent_id)`` from a process-local
  counter, prefixed with the pid.
* **Storage** is a bounded ring (``RAFT_TPU_OBS_TRACE_CAP``, default 4096
  spans) guarded by one lock.
* **Export** is Chrome trace-event JSON (:func:`chrome_trace` /
  :func:`export_chrome_trace`): one ``"X"`` event per span with its
  attributes under ``args``, plus ``"i"`` instants for the resilience
  event ring — loadable in Perfetto or ``chrome://tracing``.
* **Clocks**: :func:`clock_handshake` is the record that opens a flight
  recording (this host's epoch and monotonic readings and its offset from
  ``RAFT_TPU_FLEET_EPOCH``), which the trace stitcher subtracts.

**Sync mode** (``RAFT_TPU_OBS_SYNC=1`` / :func:`enable_sync`): CUDA work
is queued asynchronously, so a span around a search measures the enqueue,
not the card's work. Sync mode drains every visible card
(``torch.cuda.synchronize``) at span exit and records both numbers:
``dur_s`` becomes committed time, and the pre-drain wall clock rides the
span as ``dispatch_s``. It costs one synchronize per span.

This module never initialises CUDA: with no CUDA context yet, the drain is
a no-op that reports ``False``.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Optional

__all__ = [
    "alloc_id",
    "chrome_trace",
    "clear_spans",
    "clock_handshake",
    "current_span",
    "disable_sync",
    "drain_device",
    "enable_sync",
    "enter_span",
    "exit_span",
    "export_chrome_trace",
    "fleet_trace_id",
    "manual_span",
    "process_info",
    "push_span",
    "reset_fleet_ids",
    "set_ring_cap",
    "spans",
    "sync_enabled",
]

# ---------------------------------------------------------------------------
# process identity (stamps on exported records)
# ---------------------------------------------------------------------------


def _torch_process_info():
    """(rank, world size) of an already initialised ``torch.distributed``
    process group, else None. Never imports or initialises anything."""
    dist = sys.modules.get("torch.distributed")
    if dist is None:
        return None
    try:
        if not (dist.is_available() and dist.is_initialized()):
            return None
        return int(dist.get_rank()), int(dist.get_world_size())
    # a stamp is best-effort decoration: a half-torn-down group degrades
    # to "no group", never to a telemetry failure
    except (RuntimeError, ValueError):
        return None


def process_info() -> tuple:
    """(process_index, process_count) for stamping telemetry records:
    ``RAFT_TPU_PROCESS_INDEX`` / ``RAFT_TPU_PROCESS_COUNT`` when set, then
    an initialised ``torch.distributed`` group, then ``(0, 1)``."""
    pi = os.environ.get("RAFT_TPU_PROCESS_INDEX", "").strip()
    pc = os.environ.get("RAFT_TPU_PROCESS_COUNT", "").strip()
    if pi.lstrip("-").isdigit():
        return int(pi), int(pc) if pc.lstrip("-").isdigit() else 1
    live = _torch_process_info()
    if live is not None:
        return live
    return 0, 1


# ---------------------------------------------------------------------------
# sync mode (device-time attribution)
# ---------------------------------------------------------------------------

_sync = os.environ.get("RAFT_TPU_OBS_SYNC", "").strip().lower() in (
    "1", "true", "on", "yes",
)


def sync_enabled() -> bool:
    return _sync


def enable_sync() -> None:
    global _sync
    _sync = True


def disable_sync() -> None:
    global _sync
    _sync = False


def drain_device() -> bool:
    """Wait for everything queued so far on every visible card
    (``torch.cuda.synchronize`` of each). Returns False, and does nothing,
    when torch is not imported or no CUDA context exists yet: a span
    around host work must never pay for CUDA's initialisation."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return False
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    return True


# ---------------------------------------------------------------------------
# span ring + contextvar lineage
# ---------------------------------------------------------------------------

def _ring_cap() -> int:
    raw = os.environ.get("RAFT_TPU_OBS_TRACE_CAP", "").strip()
    if raw.isdigit() and int(raw) > 0:
        return int(raw)
    return 4096


_SPANS: deque = deque(maxlen=_ring_cap())  # guarded-by: _LOCK
_LOCK = threading.Lock()


def set_ring_cap(cap: int) -> None:
    """Resize the span ring at runtime (newest spans kept). The
    ``RAFT_TPU_OBS_TRACE_CAP`` env var is read once at import — a process
    that decides on a long attribution run after importing the package
    uses this instead (the runtime twin, like enable_sync for the env gate)."""
    global _SPANS
    with _LOCK:
        _SPANS = deque(_SPANS, maxlen=max(1, int(cap)))


_ids = itertools.count(1)
_ID_PREFIX = f"{os.getpid():x}"

#: (trace_id, span_id) of the innermost open span in this context
_current: contextvars.ContextVar = contextvars.ContextVar(
    "raft_tpu_torch_obs_span", default=None)


def current_span() -> Optional[tuple]:
    """(trace_id, span_id) of the innermost open span, or None."""
    return _current.get()


def _next_id() -> str:
    return f"{_ID_PREFIX}-{next(_ids)}"


def enter_span():
    """Open a span in the current context: allocate ids, inherit the trace
    from the enclosing span (or start a new trace at the root), and make
    this span the parent of anything opened inside it.

    Returns ``((trace_id, span_id, parent_id), token)``; the token MUST be
    passed back to :func:`exit_span`."""
    parent = _current.get()
    sid = _next_id()
    if parent is None:
        ids = (_next_id(), sid, None)
    else:
        ids = (parent[0], sid, parent[1])
    token = _current.set((ids[0], ids[1]))
    return ids, token


def exit_span(ids, token, *, name: str, t0: float, dur_s: float,
              attrs: Optional[dict] = None, error: Optional[str] = None,
              dispatch_s: Optional[float] = None) -> dict:
    """Close a span opened by :func:`enter_span`: restore the parent context
    and append the completed record to the ring. Returns the record."""
    _current.reset(token)
    trace_id, span_id, parent_id = ids
    rec = {
        "name": name,
        "trace_id": trace_id,
        "span_id": span_id,
        "parent_id": parent_id,
        "t0": t0,
        "dur_s": dur_s,
        "tid": threading.get_ident(),
    }
    if attrs:
        rec["attrs"] = dict(attrs)
    if error is not None:
        rec["error"] = error
    if dispatch_s is not None:
        rec["dispatch_s"] = dispatch_s
    push_span(rec)
    return rec


_fleet_ids: dict = {}  # guarded-by: _LOCK


def fleet_trace_id(site: str) -> str:
    """Fleet-scoped id of one dispatch of ``site``: ``fleet:<site>:<n>``,
    n counting this process's dispatches of the site. Not pid-prefixed:
    every SPMD process runs the same dispatch sequence, so all stamp the
    same id on one logical dispatch and the trace stitcher lines their
    tracks up on it (a span ``attrs`` entry)."""
    with _LOCK:
        n = _fleet_ids.get(site, 0) + 1
        _fleet_ids[site] = n
    return f"fleet:{site}:{n}"


def reset_fleet_ids() -> None:
    """Re-zero the per-site dispatch counters."""
    with _LOCK:
        _fleet_ids.clear()


def clock_handshake(reference_epoch: Optional[float] = None) -> dict:
    """The per-process clock-offset handshake record that opens a flight
    recording: this host's epoch and monotonic readings, plus ``offset_s``
    relative to a fleet-agreed reference epoch (``reference_epoch`` or the
    ``RAFT_TPU_FLEET_EPOCH`` env var a multi-host launcher distributes).
    With no reference the offset is 0.0 — single-host recordings stitch
    unshifted. The stitcher subtracts ``offset_s`` from a host's event
    timestamps so skewed wall clocks align on one timeline. Reads no
    device: the process identity comes from :func:`process_info`."""
    pi, pc = process_info()
    t_epoch = time.time()
    t_mono = time.monotonic()
    if reference_epoch is None:
        raw = os.environ.get("RAFT_TPU_FLEET_EPOCH", "").strip()
        try:
            reference_epoch = float(raw) if raw else None
        except ValueError:
            reference_epoch = None
    return {
        "type": "clock_offset",
        "process_index": pi,
        "process_count": pc,
        "t_epoch": round(t_epoch, 6),
        "t_mono": round(t_mono, 6),
        "offset_s": (round(t_epoch - reference_epoch, 6)
                     if reference_epoch is not None else 0.0),
    }


def alloc_id() -> str:
    """One fresh span/trace id from the process-local counter. A caller
    building spans with explicit lineage (:func:`manual_span`) allocates
    ids up front, so children can name a parent that completes later —
    the serving request, whose root span closes after its dispatch
    children were recorded on another thread."""
    return _next_id()


def manual_span(name: str, *, t0: float, dur_s: float,
                trace_id: Optional[str] = None,
                span_id: Optional[str] = None,
                parent_id: Optional[str] = None,
                attrs: Optional[dict] = None,
                error: Optional[str] = None) -> dict:
    """Record one completed span with explicit lineage, bypassing the
    contextvar stack: the cross-thread path of a serving request's
    submit → admit → dispatch → complete lifecycle, which spans the
    caller's thread and the batcher's. ``t0`` is epoch seconds. Returns
    the record put into the ring."""
    rec = {
        "name": name,
        "trace_id": trace_id if trace_id is not None else _next_id(),
        "span_id": span_id if span_id is not None else _next_id(),
        "parent_id": parent_id,
        "t0": t0,
        "dur_s": dur_s,
        "tid": threading.get_ident(),
    }
    if attrs:
        rec["attrs"] = dict(attrs)
    if error is not None:
        rec["error"] = error
    push_span(rec)
    return rec


def push_span(rec: dict) -> None:
    with _LOCK:
        _SPANS.append(rec)


def spans() -> list:
    """Snapshot of the completed-span ring, oldest first."""
    with _LOCK:
        return list(_SPANS)


def clear_spans() -> None:
    with _LOCK:
        _SPANS.clear()


# ---------------------------------------------------------------------------
# Chrome trace-event export (Perfetto / chrome://tracing)
# ---------------------------------------------------------------------------


def chrome_trace(span_records: Optional[list] = None,
                 events: Optional[list] = None,
                 extra: Optional[dict] = None) -> dict:
    """Assemble a Chrome trace-event JSON dict from span records (default:
    the ring) and instant events (default: the resilience recovery ring).

    Spans become ``"X"`` complete events (ts/dur in microseconds, pid =
    ``process_index`` so multi-host traces interleave cleanly in one
    Perfetto view); recovery events become ``"i"`` instants. Span attributes
    and ids ride under ``args`` and round-trip through the file."""
    if span_records is None:
        span_records = spans()
    if events is None:
        events = _resilience_events()
    pi, pc = process_info()
    out = []
    for rec in span_records:
        args = {
            "trace_id": rec.get("trace_id"),
            "span_id": rec.get("span_id"),
            "parent_id": rec.get("parent_id"),
        }
        args.update(rec.get("attrs") or {})
        if "error" in rec:
            args["error"] = rec["error"]
        if "dispatch_s" in rec:
            args["dispatch_s"] = rec["dispatch_s"]
        out.append({
            "name": rec.get("name", "?"),
            "cat": "span",
            "ph": "X",
            "ts": round(float(rec.get("t0", 0.0)) * 1e6, 1),
            "dur": round(float(rec.get("dur_s", 0.0)) * 1e6, 1),
            "pid": pi,
            "tid": rec.get("tid", 0),
            "args": args,
        })
    for ev in events:
        ev = dict(ev)
        out.append({
            "name": ev.pop("event", "event"),
            "cat": "resilience",
            "ph": "i",
            "s": "p",
            "ts": round(float(ev.pop("t", 0.0)) * 1e6, 1),
            "pid": pi,
            "tid": 0,
            "args": ev,
        })
    meta = {"process_index": pi, "process_count": pc}
    if extra:
        meta.update(extra)
    return {"traceEvents": out, "displayTimeUnit": "ms", "otherData": meta}


def _resilience_events() -> list:
    """The resilience event ring, reached lazily (resilience imports obs,
    so a module-level import here would be a cycle)."""
    from raft_tpu_torch.resilience.retry import recent_events

    return recent_events()


def export_chrome_trace(path, extra: Optional[dict] = None) -> dict:
    """Write :func:`chrome_trace` to ``path`` atomically
    (``core/fsio.atomic_write``) and return the dict."""
    from raft_tpu_torch.core.fsio import atomic_write

    doc = chrome_trace(extra=extra)
    with atomic_write(path, "w") as f:
        json.dump(doc, f)
    return doc
