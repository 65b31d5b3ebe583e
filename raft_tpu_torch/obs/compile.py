"""Compile ledger (counterpart of ``raft_tpu/obs/compile.py``): every new
operand signature an entry point meets, recorded with shape provenance.

The JAX package records a ledger entry each time a jitted entry point
traces. Eager PyTorch has no jit cache, so a "trace" here has a meaning of
its own:

* :func:`trace_event` ``(entry, static, **operands)`` records a ledger
  entry when ``entry`` meets an operand signature — every operand's shape
  and dtype plus the static arguments — that it has not met before in this
  process. That is the port's counterpart of a jit cache miss: a new
  signature is a new shape the kernels are planned and launched at. A
  signature already met records nothing, so a steady serving window
  leaves the ledger alone.
* Each record carries the same diff against the entry's previous recorded
  signature as the JAX ledger, so a store growth still reads "``table``
  widened ``int32[16,4]`` → ``int32[16,8]``".
* :func:`native_event` records the build and load of a CUDA kernel library
  (``ops/_native.py``, entry ``native.<source>``, keyed by the source's
  hash) on every call, and ``_native`` loads each library once a process.
  A source loaded twice under the same hash is therefore an
  **unexplained** retrace, and :func:`unexplained_retraces` stays the
  health check it is in the JAX package: zero on a healthy run.
* :func:`watch` stamps the wall clock of the block onto records made inside
  it by its own thread — around ``_native.load`` it covers ``nvcc``.

The ledger is a bounded ring (``RAFT_TPU_OBS_LEDGER_CAP``, default 512) and
records whether telemetry is on or off; per-entry counts survive ring
eviction, so :func:`trace_count` deltas stay exact. :func:`suppress_analysis`
is kept, as a context that mutes this thread's records, because
``obs.costmodel`` calls it.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Optional

from raft_tpu_torch.obs import tracing as _tracing
from raft_tpu_torch.obs.registry import add as _metric_add
from raft_tpu_torch.obs.registry import enabled as _metrics_enabled
from raft_tpu_torch.obs.registry import record_span

__all__ = [
    "LEDGER_CAP_ENV",
    "entries",
    "ledger",
    "native_event",
    "reset",
    "set_ledger_cap",
    "summary",
    "suppress_analysis",
    "trace_count",
    "trace_event",
    "unexplained_retraces",
    "watch",
]

LEDGER_CAP_ENV = "RAFT_TPU_OBS_LEDGER_CAP"
_DEFAULT_CAP = 512


def _ledger_cap() -> int:
    raw = os.environ.get(LEDGER_CAP_ENV, "").strip()
    if raw.isdigit() and int(raw) > 0:
        return int(raw)
    return _DEFAULT_CAP


_LOCK = threading.Lock()
_LEDGER: deque = deque(maxlen=_ledger_cap())  # guarded-by: _LOCK
_COUNTS: dict = {}      # guarded-by: _LOCK -- entry -> records ever
_LAST_SIG: dict = {}    # guarded-by: _LOCK -- entry -> {operand: signature}
_SEEN: dict = {}        # guarded-by: _LOCK -- entry -> {signature key}
_UNEXPLAINED = {"count": 0}  # guarded-by: _LOCK

_SUPPRESS = threading.local()


def set_ledger_cap(cap: int) -> None:
    """Resize the ledger ring (newest records kept)."""
    global _LEDGER
    with _LOCK:
        _LEDGER = deque(_LEDGER, maxlen=max(1, int(cap)))


def _sig_of(value) -> str:
    """``dtype[d0,d1,...]`` signature of one operand (a tensor or numpy
    array); ``none`` for an absent optional. A container (a Bitset filter,
    a list, tuple or dict) walks to its leaves' signatures; any other value
    is signed by its repr."""
    if value is None:
        return "none"
    shape = getattr(value, "shape", None)
    dtype = getattr(value, "dtype", None)
    if shape is not None and dtype is not None:
        name = str(dtype).replace("torch.", "")
        return f"{name}[{','.join(str(int(d)) for d in shape)}]"
    leaves = _leaves(value)
    if leaves:
        inner = "/".join(_sig_of(lf) for lf in leaves)
        return f"{type(value).__name__}({inner})"
    return repr(value)


def _leaves(value) -> list:
    """Array leaves of a container: list/tuple/dict items, or an object's
    array-valued attributes (a Bitset's words)."""
    if isinstance(value, (list, tuple)):
        items = list(value)
    elif isinstance(value, dict):
        items = [value[k] for k in sorted(value, key=str)]
    else:
        items = [v for v in vars(value).values()] \
            if hasattr(value, "__dict__") else []
    out = []
    for item in items:
        if getattr(item, "shape", None) is not None and \
                getattr(item, "dtype", None) is not None:
            out.append(item)
        elif isinstance(item, (list, tuple, dict)):
            out.extend(_leaves(item))
    return out


def _diff(prev: dict, cur: dict) -> list:
    """Which operands changed between two signatures of one entry
    (``from`` None: the operand is new; ``to`` None: it is gone)."""
    out = []
    for name in list(prev) + [n for n in cur if n not in prev]:
        a, b = prev.get(name), cur.get(name)
        if a != b:
            out.append({"operand": name, "from": a, "to": b})
    return out


def _signature(static: Optional[dict], operands: dict) -> dict:
    sig = {name: _sig_of(v) for name, v in operands.items()}
    if static:
        for key, v in static.items():
            sig[f"static.{key}"] = repr(v)
    return sig


def _record(entry: str, sig: dict, force: bool) -> None:
    key = tuple(sorted(sig.items()))
    cur = _tracing.current_span()
    with _LOCK:
        seen = _SEEN.setdefault(entry, set())
        if key in seen and not force:
            return
        seen.add(key)
        prev = _LAST_SIG.get(entry)
        seq = _COUNTS.get(entry, 0) + 1
        _COUNTS[entry] = seq
        _LAST_SIG[entry] = sig
        rec = {
            "entry": entry,
            "t": round(time.time(), 3),
            "shapes": sig,
            "trace_id": cur[0] if cur is not None else None,
            "tid": threading.get_ident(),
            "seq": seq,
            "first": prev is None,
            "changed": [] if prev is None else _diff(prev, sig),
        }
        if prev is not None and not rec["changed"]:
            _UNEXPLAINED["count"] += 1
            rec["unexplained"] = True
        _LEDGER.append(rec)
    if _metrics_enabled():
        _metric_add(f"compile.traces.{entry}")
        if rec.get("unexplained"):
            _metric_add("compile.unexplained_retraces")


def trace_event(entry: str, static: Optional[dict] = None,
                **operands) -> None:
    """Record ``entry``'s operand signature if this process has not met it
    before (the port's jit cache miss); a signature already met records
    nothing. ``operands`` are the entry's tensor arguments (only shape and
    dtype are read); ``static`` the arguments that shape its plan, so a
    new ``k`` or ``n_probes`` is attributed too."""
    if getattr(_SUPPRESS, "on", False):
        return
    _record(entry, _signature(static, operands), force=False)


def native_event(entry: str, **static) -> None:
    """Record one build-and-load of a kernel library (``native.<source>``,
    statics such as the source hash) — every call records, so loading one
    source twice under the same hash is an unexplained retrace."""
    if getattr(_SUPPRESS, "on", False):
        return
    _record(entry, _signature(static, {}), force=True)


class _Watch:
    """Stamp the block's wall clock onto the ledger records its own thread
    made inside it (``wall_s``). New records are found by the total count,
    not the ring length, which stays constant once the ring is full."""

    __slots__ = ("_t0", "_c0", "_tid")

    def __enter__(self):
        self._tid = threading.get_ident()
        with _LOCK:
            self._c0 = sum(_COUNTS.values())
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        with _LOCK:
            new = sum(_COUNTS.values()) - self._c0
            if new > 0:
                for rec in list(_LEDGER)[-min(new, len(_LEDGER)):]:
                    if rec.get("tid") == self._tid:
                        rec.setdefault("wall_s", round(dt, 6))
        return False


def watch() -> _Watch:
    """``with compile.watch(): ...`` around a dispatch or a library load:
    records made inside gain ``wall_s``."""
    return _Watch()


class _SuppressAnalysis:
    """Ledger mute for this thread (re-entrant)."""

    __slots__ = ("_prev",)

    def __enter__(self):
        self._prev = getattr(_SUPPRESS, "on", False)
        _SUPPRESS.on = True
        return self

    def __exit__(self, exc_type, exc, tb):
        _SUPPRESS.on = self._prev
        return False


def suppress_analysis() -> _SuppressAnalysis:
    """Mute this thread's ledger records inside the block (the JAX
    package's guard for analysis-only lowerings; the port has none, and
    ``obs.costmodel`` keeps the call)."""
    return _SuppressAnalysis()


def trace_count(entry: Optional[str] = None, prefix: Optional[str] = None) -> int:
    """Records ever made: for one ``entry``, for every entry under a
    ``prefix``, or in total; exact over ring eviction."""
    with _LOCK:
        if entry is not None:
            return _COUNTS.get(entry, 0)
        if prefix is not None:
            return sum(v for k, v in _COUNTS.items() if k.startswith(prefix))
        return sum(_COUNTS.values())


def unexplained_retraces() -> int:
    """Records whose signature did not change from the entry's previous
    one: a kernel library loaded twice. Zero on a healthy run."""
    with _LOCK:
        return _UNEXPLAINED["count"]


def entries() -> dict:
    """{entry: record count} for every entry that ever recorded."""
    with _LOCK:
        return dict(_COUNTS)


def ledger(entry: Optional[str] = None, prefix: Optional[str] = None) -> list:
    """Snapshot of the ring, oldest first; optionally one entry or an
    entry-name prefix."""
    with _LOCK:
        recs = list(_LEDGER)
    if entry is not None:
        recs = [r for r in recs if r["entry"] == entry]
    if prefix is not None:
        recs = [r for r in recs if r["entry"].startswith(prefix)]
    return recs


def reset() -> None:
    """Clear the ledger, counts, signatures and the seen sets (tests)."""
    with _LOCK:
        _LEDGER.clear()
        _COUNTS.clear()
        _LAST_SIG.clear()
        _SEEN.clear()
        _UNEXPLAINED["count"] = 0


def summary(recent: int = 5) -> dict:
    """Total records, per-entry counts, the unexplained residue and the
    newest ``recent`` records."""
    with record_span("obs.compile::summary"), _LOCK:
        recent = int(recent)
        recs = list(_LEDGER)[-recent:] if recent > 0 else []
        return {
            "total_traces": sum(_COUNTS.values()),
            "entries": dict(_COUNTS),
            "unexplained_retraces": _UNEXPLAINED["count"],
            "recent": [dict(r) for r in recs],
        }
