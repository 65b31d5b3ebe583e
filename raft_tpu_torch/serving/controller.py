"""Online SLO burn-rate controller (counterpart of
``raft_tpu/serving/controller.py``): the closed loop's serving half.

The offline tuner (raft_tpu_torch/tuning/autotune.py) picks an operating point
on the Pareto frontier; this module keeps live serving AT it when traffic
misbehaves. A :class:`BurnRateController` is a deadline-bounded,
faultpointed background loop (the ``CompactionManager`` /
``MaintenanceManager`` pattern) that reads the :class:`SloEngine`'s
dual-window burns each tick and nudges **one knob per tick** through its
ordered :class:`KnobActuator` list:

* **hot** (a latency/availability SLO burning — fast window over
  threshold): step the first steppable actuator DOWN one rung —
  ``n_probes`` down, batch cap down, tier demote — cheapest latency
  relief first;
* **recall burning**: any recall-costing actuator sitting BELOW its
  tuned rung steps back UP immediately — latency relief is never bought
  by holding the recall SLO under water;
* **cool** for ``RAFT_TPU_TUNE_COOL_WINDOWS`` consecutive ticks: one
  nudged actuator reverts one rung toward the tuned point (hysteresis —
  a controller that re-raises on the first quiet tick livelocks).

The shadow-recall Wilson CI is a HARD guardrail: an actuator marked
``costs_recall`` is never stepped down while the sampler's ``ci_low``
sits at/under the recall floor — the controller acts on the batch cap
instead, or holds (counted ``guardrail_holds``). Every knob move lands
as a classified ``tuning.action`` event on the resilience ring — the
flight recorder folds it into the window timeline, so a tuning episode
is reconstructible from the recording alone. Per-tick action count is
bounded by ``RAFT_TPU_TUNE_MAX_ACTIONS`` (the capacity plane's
anti-livelock pattern).

Each tick is bounded by the tuner's window deadline knob
(``RAFT_TPU_TUNE_DEADLINE_S``) and faultpointed
(``serving.controller.tick``; an armed oom, hang or fatal): a faulted
tick is skipped classified and serving never wedges. Telemetry-off contract: a disabled registry means the controller
holds ZERO state and ``tick()``/``report()`` return None.

Concurrency: a tick reads the SLO engine and the shadow sampler while
the queue's pump (and the sampler's exact scans) run searches on the same
card. The controller never holds a lock across an engine, sampler or
actuator call (the ``guarded-by`` comments name each field's lock), and a
knob move is one setter call on the live object
(``QueryQueue.set_batch_cap`` takes the queue's own lock); the next
dispatch picks the moved knob up.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from raft_tpu_torch import obs, resilience
from raft_tpu_torch.resilience.retry import record_event

__all__ = [
    "COOL_WINDOWS_ENV",
    "CONTROL_INTERVAL_ENV",
    "MAX_ACTIONS_ENV",
    "BurnRateController",
    "KnobActuator",
    "default_control_interval",
    "default_cool_windows",
    "default_max_actions",
]

MAX_ACTIONS_ENV = "RAFT_TPU_TUNE_MAX_ACTIONS"
COOL_WINDOWS_ENV = "RAFT_TPU_TUNE_COOL_WINDOWS"
CONTROL_INTERVAL_ENV = "RAFT_TPU_TUNE_INTERVAL_S"

_DEFAULT_MAX_ACTIONS = 1
_DEFAULT_COOL_WINDOWS = 2
_DEFAULT_INTERVAL_S = 1.0

#: SLO kinds whose burn means "spend recall/throughput to buy latency"
_HOT_KINDS = ("latency", "availability")


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    return int(raw) if raw.isdigit() and int(raw) > 0 else default


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    try:
        v = float(raw) if raw else default
    except ValueError:
        return default
    return v if v > 0 else default


def default_max_actions() -> int:
    """Knob moves the controller may take per tick
    (``RAFT_TPU_TUNE_MAX_ACTIONS``, default 1 — one knob per window)."""
    return _env_int(MAX_ACTIONS_ENV, _DEFAULT_MAX_ACTIONS)


def default_cool_windows() -> int:
    """Consecutive cool ticks before one revert toward the tuned point
    (``RAFT_TPU_TUNE_COOL_WINDOWS``, default 2)."""
    return _env_int(COOL_WINDOWS_ENV, _DEFAULT_COOL_WINDOWS)


def default_control_interval() -> float:
    """Background worker tick interval in seconds
    (``RAFT_TPU_TUNE_INTERVAL_S``, default 1.0)."""
    return _env_float(CONTROL_INTERVAL_ENV, _DEFAULT_INTERVAL_S)


class KnobActuator:
    """One live-settable serving knob: an ordered ladder (ascending
    latency cost — "down" buys latency), a getter and a setter reaching
    into the serving object (queue batch cap, searcher closure nprobe,
    capacity tier). The rung held at construction is the TUNED point the
    controller reverts toward. ``costs_recall`` marks the knobs the
    Wilson-CI guardrail protects."""

    def __init__(self, name: str, values, get, set, *,
                 costs_recall: bool = False):
        self.name = str(name)
        self.values = list(values)
        if not self.values:
            raise ValueError(f"actuator {name!r} has an empty ladder")
        self._get = get
        self._set = set
        self.costs_recall = bool(costs_recall)
        cur = get()
        if cur not in self.values:
            raise ValueError(
                f"actuator {name!r} live value {cur!r} not on its ladder")
        self.tuned_idx = self.values.index(cur)

    @property
    def idx(self) -> int:
        cur = self._get()
        return self.values.index(cur) if cur in self.values else \
            self.tuned_idx

    @property
    def value(self):
        return self._get()

    def step(self, direction: int):
        """Move one rung (clamped); returns (frm, to) after applying to
        the live object."""
        i = self.idx
        j = max(0, min(len(self.values) - 1, i + int(direction)))
        frm, to = self.values[i], self.values[j]
        if j != i:
            self._set(to)
        return frm, to


class BurnRateController:
    """Burn-rate-driven knob controller for one serving setup.

    ``engine`` is the :class:`raft_tpu_torch.obs.slo.SloEngine` whose
    ``evaluate()`` drives the loop; ``actuators`` is the relief-priority
    list of :class:`KnobActuator` (first = cheapest latency relief);
    ``sampler`` (optional) is the shadow sampler whose Wilson ``ci_low``
    gates recall-costing moves against ``recall_floor`` (default: the
    engine's recall SLO target when one exists). Drive it
    deterministically (:meth:`pump` in the serving loop's idle gaps) or with :meth:`start`/:meth:`stop`.
    """

    def __init__(self, engine, actuators, *, sampler=None,
                 recall_floor: Optional[float] = None,
                 max_actions: Optional[int] = None,
                 cool_windows: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 interval_s: Optional[float] = None):
        self._enabled = obs.enabled()
        if not self._enabled:
            return  # telemetry off ⇒ ZERO controller state (NOOP contract)
        from raft_tpu_torch.tuning.autotune import default_tune_deadline

        self.engine = engine
        self.actuators = list(actuators)
        if not self.actuators:
            raise ValueError("BurnRateController needs at least one "
                             "actuator")
        self.sampler = sampler
        self.recall_floor = (float(recall_floor)
                             if recall_floor is not None
                             else self._engine_recall_floor())
        self.max_actions = int(max_actions if max_actions is not None
                               else default_max_actions())
        self.cool_windows = int(cool_windows if cool_windows is not None
                                else default_cool_windows())
        self.deadline_s = float(deadline_s if deadline_s is not None
                                else default_tune_deadline())
        self.interval_s = float(interval_s if interval_s is not None
                                else default_control_interval())
        # counter plane: mutated by whichever thread wins _busy, read by
        # report() from serving threads — its own leaf lock, never held
        # across engine/sampler/actuator calls
        self._stats_lock = threading.Lock()
        self.ticks = 0            # guarded-by: _stats_lock, reads-ok
        self.nudges = 0           # guarded-by: _stats_lock, reads-ok
        self.reverts = 0          # guarded-by: _stats_lock, reads-ok
        self.holds = 0            # guarded-by: _stats_lock, reads-ok
        self.guardrail_holds = 0  # guarded-by: _stats_lock, reads-ok
        self.failures = 0         # guarded-by: _stats_lock, reads-ok
        self.breach_ticks = 0     # guarded-by: _stats_lock, reads-ok
        self.last_status: Optional[str] = None  # guarded-by: _stats_lock, reads-ok
        self._cool_streak = 0     # guarded-by: _stats_lock, reads-ok
        self._busy = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        self._stopping = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    def _engine_recall_floor(self) -> Optional[float]:
        for slo in getattr(self.engine, "slos", ()) or ():
            if getattr(slo, "kind", None) == "recall":
                return float(slo.target)
        return None

    # -- one tick -----------------------------------------------------------
    def pump(self) -> Optional[dict]:
        """One control step if no other tick is in flight — the
        deterministic entry for serving loops and tests. Returns
        the tick's decision dict, None when disabled or busy."""
        if not self._enabled:
            return None
        if not self._busy.acquire(blocking=False):
            return None  # another thread's tick is in flight
        try:
            return self._tick()
        finally:
            self._busy.release()

    def tick(self) -> Optional[dict]:
        """Alias for :meth:`pump` — the controller's unit of progress."""
        return self.pump()

    def _tick(self) -> dict:
        t0 = time.perf_counter()
        try:
            with obs.record_span("serving::controller_tick"):
                with resilience.Deadline(self.deadline_s,
                                         label="serving.controller"):
                    # faultpoint INSIDE the deadline scope: an armed hang
                    # spins on check_interrupt and is bounded by the tick
                    # deadline — a wedged tick must never wedge serving
                    resilience.faultpoint("serving.controller.tick")
                    decision = self._decide()
        except Exception as e:
            kind = resilience.classify(e)
            with self._stats_lock:
                self.ticks += 1
                self.failures += 1
                self.last_status = kind
            obs.add(f"tuning.tick.{kind.lower()}")
            record_event("tuning.tick_error", kind=kind,
                         error=repr(e)[:200])
            return {"status": kind, "actions": []}
        with self._stats_lock:
            self.ticks += 1
            self.last_status = decision["status"]
        if obs.enabled():
            obs.observe("tuning.tick_duration_s",
                        time.perf_counter() - t0)
        return decision

    def _decide(self) -> dict:
        rows = self.engine.evaluate() or {}
        hot = [n for n, r in rows.items() if isinstance(r, dict)
               and r.get("kind") in _HOT_KINDS
               and r.get("state") in ("warn", "breach")]
        recall_burn = [n for n, r in rows.items() if isinstance(r, dict)
                       and r.get("kind") == "recall"
                       and r.get("state") in ("warn", "breach")]
        breach = any(r.get("state") == "breach" for r in rows.values()
                     if isinstance(r, dict))
        actions: list = []
        budget = self.max_actions
        if recall_burn and budget > 0:
            act = self._revert_recall(recall_burn[0])
            if act is not None:
                actions.append(act)
                budget -= 1
        if hot:
            with self._stats_lock:
                self._cool_streak = 0
                if breach:
                    self.breach_ticks += 1
            while budget > 0:
                act = self._nudge_down(hot[0])
                if act is None:
                    break
                actions.append(act)
                budget -= 1
            status = "hot"
        else:
            with self._stats_lock:
                self._cool_streak += 1
                cool_enough = self._cool_streak >= self.cool_windows
            if cool_enough and budget > 0:
                act = self._revert_one("cool")
                if act is not None:
                    actions.append(act)
                    with self._stats_lock:
                        self._cool_streak = 0
            status = "cool"
        if not actions:
            with self._stats_lock:
                self.holds += 1
        return {"status": status, "hot": hot, "recall_burn": recall_burn,
                "actions": actions}

    # -- moves --------------------------------------------------------------
    def _guardrailed(self) -> bool:
        """True while the shadow-recall Wilson CI forbids recall-costing
        moves: ci_low at/under the floor, or no usable estimate at all
        (blindness is not permission)."""
        if self.recall_floor is None:
            return False
        if self.sampler is None:
            return True
        try:
            est = self.sampler.estimate()
        except Exception as e:
            resilience.classify(e)
            return True
        ci_low = est.get("ci_low") if isinstance(est, dict) else None
        if not isinstance(ci_low, (int, float)):
            return True
        return ci_low <= self.recall_floor

    def _nudge_down(self, reason: str) -> Optional[dict]:
        guarded = self._guardrailed()
        for act in self.actuators:
            if act.idx == 0:
                continue  # already at its floor
            if act.costs_recall and guarded:
                with self._stats_lock:
                    self.guardrail_holds += 1
                obs.add("tuning.guardrail_holds")
                record_event("tuning.guardrail_hold", knob=act.name,
                             reason=reason, floor=self.recall_floor)
                continue
            frm, to = act.step(-1)
            return self._record_action(act, "nudge", frm, to, reason)
        return None

    def _revert_one(self, reason: str) -> Optional[dict]:
        """One rung back toward the tuned point, latency-cheapest knob
        last to re-raise (walk the priority list in reverse so the most
        expensive relief is undone first)."""
        for act in reversed(self.actuators):
            i = act.idx
            if i == act.tuned_idx:
                continue
            frm, to = act.step(+1 if i < act.tuned_idx else -1)
            return self._record_action(act, "revert", frm, to, reason)
        return None

    def _revert_recall(self, reason: str) -> Optional[dict]:
        """A burning recall SLO immediately re-raises a recall-costing
        knob sitting below its tuned rung — the one move class exempt
        from the cool-streak hysteresis."""
        for act in reversed(self.actuators):
            if act.costs_recall and act.idx < act.tuned_idx:
                frm, to = act.step(+1)
                return self._record_action(act, "revert", frm, to, reason)
        return None

    def _record_action(self, act: KnobActuator, action: str, frm, to,
                       reason: str) -> dict:
        with self._stats_lock:
            if action == "nudge":
                self.nudges += 1
            else:
                self.reverts += 1
        obs.add(f"tuning.{action}s")
        # the flight recorder folds ring events into the window timeline:
        # this line IS the reconstructible tuning episode
        record_event("tuning.action", knob=act.name, frm=frm, to=to,
                     action=action, reason=reason)
        return {"knob": act.name, "frm": frm, "to": to, "action": action,
                "reason": reason}

    # -- worker -------------------------------------------------------------
    def start(self) -> None:
        """Run the control loop on a daemon worker thread (the
        pump-in-idle-gaps mode stays available for deterministic runs)."""
        if not self._enabled:
            return
        if self._worker is not None and self._worker.is_alive():
            return
        self._stopping = False
        self._worker = threading.Thread(
            target=self._run_loop, name="raft-tpu-controller", daemon=True)
        self._worker.start()

    def _run_loop(self) -> None:
        while not self._stopping:
            self.pump()
            time.sleep(self.interval_s)

    def stop(self, timeout: float = 30.0) -> None:
        if not self._enabled:
            return
        self._stopping = True
        if self._worker is not None:
            self._worker.join(timeout=timeout)
            self._worker = None

    # -- reporting ----------------------------------------------------------
    def report(self) -> Optional[dict]:
        """The obs-report ``tuning`` section (schema v6): the action
        ledger plus where every knob sits relative to its tuned rung."""
        if not self._enabled:
            return None
        knobs = {a.name: a.value for a in self.actuators}
        tuned = {a.name: a.values[a.tuned_idx] for a in self.actuators}
        with self._stats_lock:
            return {
                "ticks": self.ticks,
                "actions": self.nudges + self.reverts,
                "nudges": self.nudges,
                "reverts": self.reverts,
                "holds": self.holds,
                "guardrail_holds": self.guardrail_holds,
                "failures": self.failures,
                "breach_ticks": self.breach_ticks,
                "last_status": self.last_status,
                "cool_streak": self._cool_streak,
                "recall_floor": self.recall_floor,
                "knobs": knobs,
                "tuned": tuned,
            }

    def stats(self) -> Optional[dict]:
        return self.report()
