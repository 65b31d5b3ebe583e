"""Shard health registry (counterpart of
``raft_tpu/resilience/shard_health.py``): per-shard HEALTHY / SUSPECT /
LOST, and a minimum-coverage quorum.

* **HEALTHY** — serving.
* **SUSPECT** — failed its last dispatch with a recoverable kind; one
  clean pass restores HEALTHY, ``suspect_threshold`` consecutive failures
  demote to LOST.
* **LOST** — failed FATAL, or ran out of strikes; skipped until
  :meth:`ShardHealth.mark_recovered` (reload from a snapshot).

Below ``min_coverage`` of the rows (``RAFT_TPU_MIN_SHARD_COVERAGE``,
default 0.5) a dispatch raises :class:`ShardQuorumError`. Transitions feed
``distributed.shard_lost`` counters and the resilience event ring.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from raft_tpu_torch import obs
from raft_tpu_torch.resilience.errors import FATAL, classify
from raft_tpu_torch.resilience.retry import record_event

HEALTHY = "healthy"
SUSPECT = "suspect"
LOST = "lost"

STATES = (HEALTHY, SUSPECT, LOST)

ENV_MIN_COVERAGE = "RAFT_TPU_MIN_SHARD_COVERAGE"
DEFAULT_MIN_COVERAGE = 0.5

#: the recovery action stamped on every shard-lost event
RECOVERY_ACTION = "reload_from_snapshot"


class ShardQuorumError(RuntimeError):
    """Surviving shards cover less than the minimum-coverage quorum.
    Classified FATAL (never retried verbatim): the fix is operator action —
    recover shards from snapshots — not a re-dispatch."""


def _env_min_coverage() -> float:
    raw = os.environ.get(ENV_MIN_COVERAGE, "").strip()
    try:
        val = float(raw) if raw else DEFAULT_MIN_COVERAGE
    except ValueError:
        val = DEFAULT_MIN_COVERAGE
    return min(max(val, 0.0), 1.0)


class ShardHealth:
    """Thread-safe per-shard state registry (shards are ranks)."""

    def __init__(self, suspect_threshold: int = 2,
                 min_coverage: Optional[float] = None):
        self.suspect_threshold = max(1, int(suspect_threshold))
        self.min_coverage = (_env_min_coverage() if min_coverage is None
                             else min(max(float(min_coverage), 0.0), 1.0))
        self._lock = threading.Lock()
        self._states: Dict[int, str] = {}     # guarded-by: _lock
        self._strikes: Dict[int, int] = {}    # guarded-by: _lock
        self._last_kind: Dict[int, str] = {}  # guarded-by: _lock

    # -- queries ------------------------------------------------------------

    def state(self, shard: int) -> str:
        with self._lock:
            return self._states.get(int(shard), HEALTHY)

    def last_kind(self, shard: int) -> str:
        """Failure kind of the shard's most recent reported failure."""
        with self._lock:
            return self._last_kind.get(int(shard), "")

    def lost(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(sorted(s for s, st in self._states.items()
                                if st == LOST))

    def serving_mask(self, world: int) -> np.ndarray:
        """(world,) bool: shards eligible to serve the next dispatch
        (everything not LOST — SUSPECT shards get another chance)."""
        with self._lock:
            return np.array([self._states.get(r, HEALTHY) != LOST
                             for r in range(int(world))], dtype=bool)

    def snapshot(self) -> dict:
        """Diagnostic view: {shard: {state, strikes, last_kind}}."""
        with self._lock:
            return {r: {"state": st,
                        "strikes": self._strikes.get(r, 0),
                        "last_kind": self._last_kind.get(r, "")}
                    for r, st in sorted(self._states.items())}

    # -- transitions --------------------------------------------------------

    def report_failure(self, shard: int, exc: BaseException) -> str:
        """Fold one dispatch failure into the shard's state; returns the new
        state. FATAL loses the shard immediately; recoverable kinds mark it
        SUSPECT and demote to LOST after ``suspect_threshold`` consecutive
        strikes."""
        shard = int(shard)
        kind = classify(exc)
        with self._lock:
            strikes = self._strikes.get(shard, 0) + 1
            self._strikes[shard] = strikes
            self._last_kind[shard] = kind
            new = (LOST if kind == FATAL or strikes >= self.suspect_threshold
                   else SUSPECT)
            was = self._states.get(shard, HEALTHY)
            self._states[shard] = new
        record_event("shard_failure", site=f"shard[{shard}]", kind=kind,
                     state=new, strikes=strikes)
        if new == LOST and was != LOST:
            obs.add("distributed.shard_lost")
            record_event("shard_lost", site=f"shard[{shard}]", kind=kind,
                         recovery=RECOVERY_ACTION)
        return new

    def report_success(self, shard: int) -> None:
        """A clean dispatch through this shard: SUSPECT heals to HEALTHY
        and the strike count resets. (LOST shards are never probed, so a
        success report for one is a recovery bug — flagged loudly.)"""
        shard = int(shard)
        with self._lock:
            if self._states.get(shard, HEALTHY) == LOST:
                raise RuntimeError(
                    f"shard {shard} is LOST; recover it via mark_recovered "
                    f"(reload from snapshot), not a success report")
            self._states[shard] = HEALTHY
            self._strikes[shard] = 0

    def mark_lost(self, shard: int, reason: str = "") -> None:
        """Administrative demotion (a coordinator noticed a dead host)."""
        shard = int(shard)
        with self._lock:
            was = self._states.get(shard, HEALTHY)
            self._states[shard] = LOST
            kind = self._last_kind.setdefault(shard, FATAL)
        if was != LOST:
            obs.add("distributed.shard_lost")
            record_event("shard_lost", site=f"shard[{shard}]",
                         kind=kind, reason=reason,
                         recovery=RECOVERY_ACTION)

    def mark_recovered(self, shard: int) -> None:
        """The shard's data is back (snapshot reload): full reinstatement."""
        shard = int(shard)
        with self._lock:
            self._states[shard] = HEALTHY
            self._strikes[shard] = 0
            self._last_kind.pop(shard, None)
        obs.add("distributed.shard_recovered")
        record_event("shard_recovered", site=f"shard[{shard}]",
                     action=RECOVERY_ACTION)

    # -- quorum -------------------------------------------------------------

    def check_quorum(self, coverage: float, context: str = "") -> None:
        """Raise :class:`ShardQuorumError` when ``coverage`` (fraction of
        rows the surviving shards hold) is below the minimum-coverage
        quorum."""
        if coverage < self.min_coverage:
            obs.add("distributed.quorum_lost")
            record_event("quorum_lost", site=context,
                         coverage=round(float(coverage), 4),
                         min_coverage=self.min_coverage,
                         lost=list(self.lost()))
            raise ShardQuorumError(
                f"shard quorum lost{': ' + context if context else ''}: "
                f"surviving shards cover {coverage:.2%} of rows < minimum "
                f"{self.min_coverage:.2%} ({ENV_MIN_COVERAGE}); lost shards "
                f"{list(self.lost())} need recovery ({RECOVERY_ACTION})")


# ---------------------------------------------------------------------------
# process-global registry (one group of shards per process in practice)
# ---------------------------------------------------------------------------

_GLOBAL: Optional[ShardHealth] = None  # guarded-by: _GLOBAL_LOCK
_GLOBAL_LOCK = threading.Lock()


def shard_health() -> ShardHealth:
    """The process-global registry the distributed searches consult by
    default (pass an explicit :class:`ShardHealth` to scope one index)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = ShardHealth()
        return _GLOBAL


def reset_shard_health() -> None:
    """Forget all shard state (tests; also re-reads the quorum env knob)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = None
