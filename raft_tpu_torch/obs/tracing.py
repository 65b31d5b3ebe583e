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
* **Clocks**: a record's ``t0`` is epoch seconds (``time.time()``) at
  entry and ``dur_s`` host seconds (``time.perf_counter()``) to its exit,
  so its start and end sit on the clock of ``torch.profiler``'s events
  (kineto's ``start_ns()`` is epoch nanoseconds). The Chrome export writes
  ``ts`` as epoch microseconds on that clock: a span trace and a profiler
  trace of one process overlay in Perfetto without a shift.
  :func:`clock_handshake` is the record that opens a flight recording
  (this host's epoch and monotonic readings and its offset from
  ``RAFT_TPU_FLEET_EPOCH``), which the trace stitcher subtracts.

**Device time** (telemetry on, a CUDA context present): a span records one
CUDA event at entry and one at exit on the current stream
(:func:`device_mark`), both from a pool, so a warm span creates none. The
pair waits in a pending queue; later span exits resolve the pairs the card
has passed (``Event.query()``, never a wait), as does the registry's
snapshot; :func:`settle_device` waits once for the rest — :func:`spans`,
the registry's ``settle`` and the Chrome export call it. A resolved pair sets ``device_s`` on its record
(the card's time from the entry mark to the exit mark) and hands it to the
span's sink, which adds it to the registry's per-name totals; the queue
holds the record itself, so the totals stay exact when the ring evicts it.

**Sync mode** (``RAFT_TPU_OBS_SYNC=1`` / :func:`enable_sync`): CUDA work
is queued asynchronously, so a span around a search measures the enqueue,
not the card's work. Sync mode drains every visible card
(``torch.cuda.synchronize``) at span exit and records both numbers:
``dur_s`` becomes committed time, and the pre-drain wall clock rides the
span as ``dispatch_s``; its ``device_s`` alone feeds the registry's
``dispatch.*`` fold (obs/roofline's measured leg). It costs one
synchronize per span.

This module never initialises CUDA: with no CUDA context yet, the drain is
a no-op that reports ``False`` and a span takes no events.
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
    "defer_device",
    "device_mark",
    "discard_device",
    "disable_sync",
    "drain_device",
    "enable_sync",
    "enter_span",
    "exit_span",
    "export_chrome_trace",
    "fleet_trace_id",
    "manual_span",
    "pending_device",
    "process_info",
    "push_span",
    "reset_fleet_ids",
    "resolve_device",
    "set_ring_cap",
    "settle_device",
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
# device time (CUDA event pairs, resolved without a wait inside a request)
# ---------------------------------------------------------------------------

_EVENT_POOL: list = []      # guarded-by: _DEV_LOCK
#: (record, entry event, exit event, sink) per span whose pair is unresolved
_PENDING: deque = deque()   # guarded-by: _DEV_LOCK
_DEV_LOCK = threading.Lock()
#: one Stream object per (stream id, device, type) the marks were put on
_STREAMS: dict = {}


def _current_stream(torch):
    """``torch.cuda.current_stream()`` without its Python-side device
    lookup, which costs more than the event's record itself."""
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = _STREAMS.get(key)
    if stream is None:
        stream = _STREAMS[key] = torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2])
    return stream


def device_mark():
    """A CUDA event recorded on the current stream, taken from the pool
    (created only when the pool is empty), or None when torch is not
    imported or no CUDA context exists yet."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    with _DEV_LOCK:
        ev = _EVENT_POOL.pop() if _EVENT_POOL else None
    if ev is None:
        ev = torch.cuda.Event(enable_timing=True)
    ev.record(_current_stream(torch))
    return ev


def _drain_pending(wait: bool) -> None:
    """Resolve the pending pairs the card has passed, oldest first; with
    ``wait``, first wait (outside the lock) for the newest exit mark of
    each device, so every pair queued until then resolves. Their events go
    back to the pool."""
    if wait:
        with _DEV_LOCK:
            newest = {entry[2].device: entry[2] for entry in _PENDING}
        for ev in newest.values():
            ev.synchronize()
    done = []
    with _DEV_LOCK:
        while _PENDING and _PENDING[0][2].query():
            rec, ev0, ev1, sink = _PENDING.popleft()
            seconds = ev0.elapsed_time(ev1) * 1e-3
            rec["device_s"] = seconds
            done.append((rec, seconds, sink))
            _EVENT_POOL.extend((ev0, ev1))
    for rec, seconds, sink in done:
        sink(rec["name"], seconds, rec.get("trace_id"))


def defer_device(rec: dict, ev0, ev1, sink) -> None:
    """Queue a span's event pair: ``rec["device_s"]`` and ``sink(name,
    seconds, trace_id)`` follow once the card has passed ``ev1``. Resolves
    the earlier pairs the card has already passed, without waiting."""
    with _DEV_LOCK:
        _PENDING.append((rec, ev0, ev1, sink))
    _drain_pending(wait=False)


def resolve_device() -> None:
    """Resolve the pending pairs the card has already passed, without
    waiting (the registry's snapshot)."""
    _drain_pending(wait=False)


def settle_device() -> None:
    """Wait once for every pending span's exit mark and resolve them all:
    the one wait on the card that telemetry makes, outside any request
    (the span snapshot, the registry's settle, the Chrome export)."""
    _drain_pending(wait=True)


def discard_device(owner) -> None:
    """Forget the pending pairs whose sink is bound to ``owner`` without
    waiting: their records keep no ``device_s`` and their events go back to
    the pool (a pending event may be recorded again). A registry's reset
    calls it, so a new window's totals never take an older window's
    spans."""
    with _DEV_LOCK:
        keep = deque()
        for entry in _PENDING:
            if getattr(entry[3], "__self__", None) is owner:
                _EVENT_POOL.extend((entry[1], entry[2]))
            else:
                keep.append(entry)
        _PENDING.clear()
        _PENDING.extend(keep)


def pending_device() -> int:
    """Spans whose device time is not resolved yet."""
    with _DEV_LOCK:
        return len(_PENDING)


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
    """Snapshot of the completed-span ring, oldest first, with every
    pending device time resolved (:func:`settle_device`)."""
    settle_device()
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

    Spans become ``"X"`` complete events (ts in epoch microseconds, the
    profiler's clock, and dur in microseconds; pid = ``process_index`` so
    multi-host traces interleave cleanly in one Perfetto view); recovery
    events become ``"i"`` instants. Span attributes, ids, ``dispatch_s``
    and ``device_s`` ride under ``args`` and round-trip through the file."""
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
        for key in ("dispatch_s", "device_s"):
            if key in rec:
                args[key] = rec[key]
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
