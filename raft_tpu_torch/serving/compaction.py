"""Background compaction (counterpart of ``raft_tpu/serving/compaction.py``):
tombstone-ratio-triggered, off the hot path.

Deletes tombstone in place (serving/store.py) — the slots stay dead until
:meth:`~raft_tpu_torch.serving.PagedListStore.compact` folds the live rows back
together. Left alone, a delete-heavy serving window accumulates dead
slots the paged scans still DMA past (``tombstone_fraction`` in the paged
occupancy stats) and the page pool's free list starves into growth
retraces. The :class:`CompactionManager` closes the loop: when
``tombstones / live_rows`` crosses ``RAFT_TPU_SERVING_COMPACT_RATIO`` it
runs one compaction CYCLE —

1. ``store.compact()`` — fold the live rows into the packed layout
   (only the row snapshot holds the store lock; the fold runs on
   immutable array snapshots, so serving traffic is never stalled);
2. ``store.compact_swap(packed, v0)`` — re-page at the SAME capacity and
   table width and swap atomically, validated against the
   ``mutation_version`` observed before the fold: a mutation that landed
   mid-cycle aborts the swap (classified ``stale``, retried on the next
   pump) instead of being lost. In-flight ``QueryQueue`` dispatches hold
   their own tensor snapshots and are untouched either way; capacity is
   unchanged, so the paged scans keep their operand shapes.

The cycle is deadline-bounded (``RAFT_TPU_SERVING_COMPACT_DEADLINE_S``,
:class:`raft_tpu_torch.resilience.Deadline`), faultpointed
(``serving.compact.run``; the tests arm oom, fatal and delay there and
assert the classified outcome), and every failure
routes through ``resilience.classify`` into counters + the event ring.

Drive it deterministically (:meth:`CompactionManager.pump` in the serving
loop's idle gaps — what the bench and tier-1 do) or with the background
worker (:meth:`start` / :meth:`stop`).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from raft_tpu_torch import obs, resilience
from raft_tpu_torch.resilience.retry import record_event

COMPACT_RATIO_ENV = "RAFT_TPU_SERVING_COMPACT_RATIO"
COMPACT_DEADLINE_ENV = "RAFT_TPU_SERVING_COMPACT_DEADLINE_S"
COMPACT_INTERVAL_ENV = "RAFT_TPU_SERVING_COMPACT_INTERVAL_S"

_DEFAULT_RATIO = 0.25
_DEFAULT_DEADLINE_S = 30.0
_DEFAULT_INTERVAL_S = 0.5


def _env_float(env: str, default: float) -> float:
    raw = os.environ.get(env, "").strip()
    if not raw:
        return default
    try:
        v = float(raw)
    except ValueError:
        return default
    return v if v > 0 else default


def default_compact_ratio() -> float:
    """Trigger threshold on ``tombstones / live_rows``
    (``RAFT_TPU_SERVING_COMPACT_RATIO``, default 0.25)."""
    return _env_float(COMPACT_RATIO_ENV, _DEFAULT_RATIO)


def default_compact_deadline() -> float:
    """Per-cycle wall-clock bound in seconds
    (``RAFT_TPU_SERVING_COMPACT_DEADLINE_S``, default 30)."""
    return _env_float(COMPACT_DEADLINE_ENV, _DEFAULT_DEADLINE_S)


class CompactionManager:
    """Tombstone-ratio-triggered compaction manager for one store.

    ``ratio``/``deadline_s`` default from the env knobs;
    ``min_tombstones`` keeps tiny stores from compacting on their first
    delete. Thread-safe against the store's own locking; only one cycle
    runs at a time (``pump`` from two threads serializes on ``_busy``).
    """

    def __init__(self, store, *, ratio: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 min_tombstones: int = 1,
                 interval_s: Optional[float] = None):
        self.store = store
        self.ratio = float(ratio if ratio is not None
                           else default_compact_ratio())
        self.deadline_s = float(deadline_s if deadline_s is not None
                                else default_compact_deadline())
        self.min_tombstones = int(min_tombstones)
        self.interval_s = float(interval_s if interval_s is not None
                                else _env_float(COMPACT_INTERVAL_ENV,
                                                _DEFAULT_INTERVAL_S))
        # counter plane: mutated by whichever thread wins _busy (and by
        # should_compact from ANY caller), read by stats() from serving
        # threads — its own leaf lock, never held across store calls
        self._stats_lock = threading.Lock()
        self.cycles = 0          # guarded-by: _stats_lock, reads-ok
        self.stale_swaps = 0     # guarded-by: _stats_lock, reads-ok
        self.failures = 0        # guarded-by: _stats_lock, reads-ok
        self.last_status: Optional[str] = None      # guarded-by: _stats_lock, reads-ok
        self.last_duration_s: Optional[float] = None  # guarded-by: _stats_lock, reads-ok
        self.tombstone_ratio_peak = 0.0  # guarded-by: _stats_lock, reads-ok
        self._busy = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        self._stopping = False

    # -- policy -------------------------------------------------------------
    def should_compact(self) -> bool:
        """True when the store's tombstone load crosses the trigger."""
        ratio = self.store.tombstone_ratio
        with self._stats_lock:
            if ratio > self.tombstone_ratio_peak:
                self.tombstone_ratio_peak = ratio
        return (self.store.tombstones >= self.min_tombstones
                and ratio > self.ratio)

    # -- one cycle ----------------------------------------------------------
    def pump(self) -> Optional[dict]:
        """One scheduler step: run a compaction cycle if the trigger
        fires (and no other cycle is in flight). Returns the cycle's
        status dict, or None when there was nothing to do — the
        deterministic entry for serving loops and tier-1 tests."""
        if not self.should_compact():
            return None
        if not self._busy.acquire(blocking=False):
            return None  # another thread's cycle is in flight
        try:
            return self._cycle()
        finally:
            self._busy.release()

    def _cycle(self) -> dict:
        store = self.store
        t0 = time.perf_counter()
        v0 = store.mutation_version
        tombstones0 = store.tombstones
        attrs = ({"tombstones": tombstones0, "version": v0}
                 if obs.enabled() else None)
        try:
            with obs.record_span("serving::compact_cycle", attrs=attrs):
                with resilience.Deadline(self.deadline_s,
                                         label="serving.compact"):
                    # faultpoint INSIDE the deadline scope: an armed hang
                    # spins on check_interrupt and must be bounded by
                    # deadline_s, not the fault's own safety cap
                    resilience.faultpoint("serving.compact.run")
                    packed = store.compact()
                    swapped = store.compact_swap(packed, v0)
        except Exception as e:
            kind = resilience.classify(e)
            with self._stats_lock:
                self.failures += 1
                self.last_status = kind
                self.last_duration_s = time.perf_counter() - t0
            obs.add(f"serving.compact.{kind.lower()}")
            record_event("serving_compact_error", kind=kind,
                         tombstones=tombstones0, error=repr(e)[:200])
            return {"status": kind, "tombstones": tombstones0,
                    "duration_s": self.last_duration_s}
        dt = time.perf_counter() - t0
        if not swapped:
            # a mutation landed between the snapshot and the swap: the
            # cycle's work is discarded, nothing changed, the next pump
            # retries against the new version — classified, never silent
            with self._stats_lock:
                self.last_duration_s = dt
                self.stale_swaps += 1
                self.last_status = "stale"
            obs.add("serving.compact.stale")
            record_event("serving_compact_stale", tombstones=tombstones0,
                         version=v0)
            return {"status": "stale", "tombstones": tombstones0,
                    "duration_s": dt}
        with self._stats_lock:
            self.last_duration_s = dt
            self.cycles += 1
            self.last_status = "ok"
        if obs.enabled():
            obs.add("serving.compact.cycles")
            obs.observe("serving.compact.duration_s", dt)
            obs.add("serving.compact.reclaimed_rows", tombstones0)
        return {"status": "ok", "reclaimed": tombstones0,
                "duration_s": dt}

    # -- worker -------------------------------------------------------------
    def start(self) -> None:
        """Run the trigger check on a daemon worker thread — compaction
        truly off the serving thread (the bench's pump-in-idle-gaps mode
        stays available for deterministic runs)."""
        if self._worker is not None and self._worker.is_alive():
            return
        self._stopping = False
        self._worker = threading.Thread(
            target=self._run_loop, name="raft-tpu-torch-compaction",
            daemon=True)
        self._worker.start()

    def _run_loop(self) -> None:
        stale_streak = 0
        while not self._stopping:
            out = self.pump()
            if out is not None and out.get("status") == "stale":
                # ONE immediate retry (the trigger still holds and the
                # race was probably transient) — but a store mutating
                # faster than a fold completes would otherwise livelock
                # this thread into back-to-back discarded folds, so
                # repeated staleness backs off to the poll interval
                stale_streak += 1
                if stale_streak <= 1:
                    continue
            else:
                stale_streak = 0
            time.sleep(self.interval_s)

    def stop(self, timeout: float = 30.0) -> None:
        self._stopping = True
        if self._worker is not None:
            self._worker.join(timeout=timeout)
            self._worker = None

    def stats(self) -> dict:
        ratio = self.store.tombstone_ratio  # store call OUTSIDE the lock
        with self._stats_lock:
            return {
                "cycles": self.cycles,
                "stale_swaps": self.stale_swaps,
                "failures": self.failures,
                "last_status": self.last_status,
                "last_duration_s": self.last_duration_s,
                "tombstone_ratio": ratio,
                "tombstone_ratio_peak": round(self.tombstone_ratio_peak, 4),
                "ratio_threshold": self.ratio,
                "deadline_s": self.deadline_s,
            }
