"""SLO engine (counterpart of ``raft_tpu/obs/slo.py``): objectives +
sliding-window error-budget burn rates.

The serving layer records latency histograms, verdict counters and a live
recall sampler; this module rolls objectives on top of them, so "is the
service healthy right now?" has a mechanical answer. Objectives cover the
three serving SLO classes —

* **latency** — "p-quantile ≤ target seconds", scored from a registry
  power-of-two histogram (a bucket whose upper bound exceeds the target
  counts as a violation — the same conservative upper-bound convention as
  ``p99_ub``, which can overcount the bad requests by up to 2×); the error
  budget is ``1 − quantile``;
* **availability** — "fraction of non-error verdicts ≥ target", scored
  from the ``QueryQueue`` verdict counters (``serving.requests.ok`` vs the
  classified failure kinds). Verdict counters fire exactly once per
  request, so requeued-once survivors (OOM cap-halving, partial deadline
  drains — the ``serving.queue.requeued`` counter) never double-count
  their first admission;
* **recall** — "live recall@k ≥ floor", scored from the shadow sampler's
  cumulative ``(matched, total)`` slot counts (obs/shadow.py).

Burn rate is the SRE error-budget formulation: ``bad_rate / budget`` over
a window — burn 1.0 spends the budget exactly at the objective's rate,
burn N spends it N× too fast. The engine keeps a ring of cumulative
samples and evaluates **dual windows** (fast = ``RAFT_TPU_OBS_BURN_FAST_S``,
slow = ``RAFT_TPU_OBS_BURN_SLOW_S``): a breach requires BOTH windows above
the threshold (fast-only is "warn"), which filters blips without missing
sustained burns. Windows older than the engine degrade to since-start.

Failure contract: burn-rate breaches emit **classified events** through
the resilience ring (``slo_breach``) plus ``slo.breach.*`` counters —
never exceptions; a broken signal source degrades that one objective to
``state="unknown"`` with its ``resilience.classify`` kind while the rest
keep evaluating.

Each :meth:`SloEngine.evaluate` result pairs a configuration's measured
burn rates with its live recall estimate: the record the autotuner
(``tuning/autotune.py``) and the burn-rate controller
(``serving/controller.py``) consume. Host-side only: the engine reads
registry snapshots and never touches the card.
"""

from __future__ import annotations

import math
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from raft_tpu_torch import obs, resilience
from raft_tpu_torch.resilience.retry import record_event

__all__ = [
    "AVAILABILITY",
    "FAST_WINDOW_ENV",
    "LATENCY",
    "RECALL",
    "SLOW_WINDOW_ENV",
    "Slo",
    "SloEngine",
    "THRESHOLD_ENV",
    "availability_slo",
    "default_serving_slos",
    "latency_slo",
    "recall_slo",
]

LATENCY = "latency"
AVAILABILITY = "availability"
RECALL = "recall"

FAST_WINDOW_ENV = "RAFT_TPU_OBS_BURN_FAST_S"
SLOW_WINDOW_ENV = "RAFT_TPU_OBS_BURN_SLOW_S"
THRESHOLD_ENV = "RAFT_TPU_OBS_BURN_THRESHOLD"

#: verdict counters that are NOT availability errors (DEADLINE verdicts are
#: counted against availability: a deadline miss is a failed request from
#: the caller's seat, which is what the availability SLO promises about)
_DEFAULT_GOOD = "serving.requests.ok"
_DEFAULT_BAD = ("serving.requests.deadline", "serving.requests.fatal",
                "serving.requests.oom", "serving.requests.transient")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


@dataclass(frozen=True)
class Slo:
    """One declared objective. Use the :func:`latency_slo` /
    :func:`availability_slo` / :func:`recall_slo` constructors — they pick
    the right ``kind``/``budget`` pairing and validate it."""

    name: str
    kind: str  # LATENCY | AVAILABILITY | RECALL
    target: float          # latency: seconds bound; others: min fraction
    budget: float          # allowed bad fraction (> 0, the burn denominator)
    hist: str = ""                                 # latency source
    good_counter: str = _DEFAULT_GOOD              # availability source
    bad_counters: Tuple[str, ...] = _DEFAULT_BAD   # availability source
    counts: Optional[Callable] = None              # recall source

    def __post_init__(self):
        if self.kind not in (LATENCY, AVAILABILITY, RECALL):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if not (0.0 < self.budget <= 1.0):
            raise ValueError(
                f"SLO {self.name!r}: budget must be in (0, 1], got "
                f"{self.budget} — a zero budget makes every burn infinite")


def latency_slo(name: str, hist: str, target_s: float,
                quantile: float = 0.99) -> Slo:
    """"``quantile`` of ``hist`` observations ≤ ``target_s``" — e.g. p99
    of ``serving.request_latency_s`` under the serving SLO."""
    if not (0.0 < quantile < 1.0):
        raise ValueError(f"quantile must be in (0, 1), got {quantile}")
    return Slo(name=name, kind=LATENCY, target=float(target_s),
               budget=1.0 - quantile, hist=hist)


def availability_slo(name: str, target: float = 0.999,
                     good_counter: str = _DEFAULT_GOOD,
                     bad_counters: Tuple[str, ...] = _DEFAULT_BAD) -> Slo:
    """"fraction of ok verdicts ≥ ``target``" over the once-per-request
    verdict counters."""
    if not (0.0 < target < 1.0):
        raise ValueError(f"availability target must be in (0, 1), "
                         f"got {target}")
    return Slo(name=name, kind=AVAILABILITY, target=float(target),
               budget=1.0 - target, good_counter=good_counter,
               bad_counters=tuple(bad_counters))


def recall_slo(name: str, counts: Callable, floor: float = 0.95) -> Slo:
    """"live recall@k ≥ ``floor``" over ``counts() -> (matched, total)``
    (a :meth:`~raft_tpu_torch.obs.shadow.ShadowSampler.counts` bound method)."""
    if not (0.0 < floor < 1.0):
        raise ValueError(f"recall floor must be in (0, 1), got {floor}")
    return Slo(name=name, kind=RECALL, target=float(floor),
               budget=1.0 - floor, counts=counts)


def default_serving_slos(target_p99_s: float, sampler=None,
                         availability_target: float = 0.999,
                         recall_floor: float = 0.95) -> tuple:
    """The serving layer's three-class objective set: p99 latency over
    ``serving.request_latency_s``, availability over the verdict counters,
    and (when a shadow ``sampler`` is wired) the live recall floor."""
    slos = [
        latency_slo("serving_p99", "serving.request_latency_s",
                    target_s=target_p99_s, quantile=0.99),
        availability_slo("serving_availability",
                         target=availability_target),
    ]
    if sampler is not None:
        slos.append(recall_slo("serving_recall", sampler.counts,
                               floor=recall_floor))
    return tuple(slos)


def _hist_good_bad(snap: dict, hist: str, target_s: float) -> tuple:
    """(good, bad) cumulative counts from a pow2 histogram: a bucket whose
    upper bound exceeds the target MAY hold violations — counted bad, the
    ≤2× conservative convention shared with ``p99_ub``."""
    h = (snap.get("histograms") or {}).get(hist) or {}
    total = int(h.get("count", 0))
    bad = 0
    for key, n in (h.get("buckets") or {}).items():
        try:
            bound = float(str(key)[3:])
        except (ValueError, IndexError):
            continue
        if bound > target_s:
            bad += int(n)
    return total - bad, bad


class SloEngine:
    """Cumulative-sample ring + dual-window burn-rate evaluation over a
    set of :class:`Slo` objectives.

    ``clock`` is injectable (tests drive synthetic timelines); windows and
    the breach threshold come from the ``RAFT_TPU_OBS_BURN_*`` env knobs
    unless given explicitly.
    """

    def __init__(self, slos, *, registry=None,
                 fast_window_s: Optional[float] = None,
                 slow_window_s: Optional[float] = None,
                 threshold: Optional[float] = None,
                 clock: Callable = time.monotonic):
        self.slos = tuple(slos)
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self._registry = registry
        self.fast_window_s = (_env_float(FAST_WINDOW_ENV, 60.0)
                              if fast_window_s is None else
                              float(fast_window_s))
        self.slow_window_s = (_env_float(SLOW_WINDOW_ENV, 600.0)
                              if slow_window_s is None else
                              float(slow_window_s))
        self.threshold = (_env_float(THRESHOLD_ENV, 10.0)
                          if threshold is None else float(threshold))
        self._clock = clock
        self._samples: deque = deque(maxlen=4096)
        self._last_state = {s.name: "ok" for s in self.slos}
        # baseline sample at construction: burn rates answer "since when?",
        # and for a fresh engine the honest answer is "since it started
        # watching" — without this, traffic that predates the engine would
        # either vanish (zero delta) or be blamed on the first window
        self.sample()

    def _snapshot(self) -> dict:
        reg = self._registry if self._registry is not None else \
            obs.registry()
        return reg.snapshot()

    def _good_bad(self, slo: Slo, snap: dict) -> tuple:
        if slo.kind == LATENCY:
            return _hist_good_bad(snap, slo.hist, slo.target)
        if slo.kind == AVAILABILITY:
            counters = snap.get("counters") or {}
            good = int(counters.get(slo.good_counter, 0))
            bad = int(sum(counters.get(c, 0) for c in slo.bad_counters))
            return good, bad
        matched, total = slo.counts()  # RECALL
        return int(matched), int(total) - int(matched)

    # -- sampling -----------------------------------------------------------
    def sample(self, snapshot: Optional[dict] = None,
               now: Optional[float] = None) -> dict:
        """Append one cumulative ``(good, bad)`` sample per objective to
        the window ring (call periodically — each serving window boundary,
        each load step). Returns the appended sample. A failing
        source records zeros for its objective, classified, and never
        raises (hot-path contract)."""
        with obs.record_span("obs.slo::sample"):
            now = self._clock() if now is None else now
            snap = self._snapshot() if snapshot is None else snapshot
            cum = {}
            for slo in self.slos:
                try:
                    cum[slo.name] = self._good_bad(slo, snap)
                except Exception as e:
                    kind = resilience.classify(e)
                    record_event("slo_source_error", site=slo.name,
                                 kind=kind, error=repr(e)[:200])
                    if obs.enabled():
                        obs.add(f"slo.source_error.{kind}")
                    cum[slo.name] = None
            rec = {"t": now, "cum": cum}
            self._samples.append(rec)
            return rec

    def _window_delta(self, name: str, now: float, window_s: float,
                      newest) -> tuple:
        """(Δgood, Δbad) between the newest sample and the sample CLOSEST
        to the window start ``now − window_s`` (ties prefer the earlier
        sample). For an engine younger than the window this degrades to
        since-start; a sparse ring picks the nearest cumulative point
        rather than silently stretching the window to the whole history —
        which would dilute exactly the fast-window bursts dual-window
        alerting exists to catch. The newest sample itself is never the
        baseline (unless it is the ONLY sample): when sampling is sparser
        than the window, self-as-baseline would collapse every burn to 0
        and a sustained 100% failure rate could never breach."""
        t_start = now - window_s
        base = fallback = None
        best = math.inf
        for rec in self._samples:
            cum = rec["cum"].get(name)
            if cum is None:
                continue
            if cum is newest:
                fallback = cum  # sole-sample case only
                continue
            dist = abs(rec["t"] - t_start)
            if dist < best:
                best = dist
                base = cum
        if base is None:
            base = fallback
        if base is None or newest is None:
            return 0, 0
        return newest[0] - base[0], newest[1] - base[1]

    # -- evaluation ---------------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> dict:
        """Sample, then score every objective: ``{name: {"kind", "target",
        "value", "good", "bad", "burn_fast", "burn_slow", "burn_rate",
        "state"}}``. Burn rates are always finite (no traffic ⇒ 0.0);
        ``state`` is ``ok`` / ``warn`` (fast window burning) / ``breach``
        (BOTH windows above threshold — emits a classified ``slo_breach``
        event + counter on the transition) / ``unknown`` (source failed).
        Never raises."""
        with obs.record_span("obs.slo::evaluate"):
            now = self._clock() if now is None else now
            sampled = self.sample(now=now)
            out = {}
            for slo in self.slos:
                newest = sampled["cum"].get(slo.name)
                if newest is None:
                    out[slo.name] = {"kind": slo.kind, "target": slo.target,
                                     "state": "unknown"}
                    self._last_state[slo.name] = "unknown"
                    continue
                good, bad = newest
                total = good + bad
                burns = {}
                for label, win in (("burn_fast", self.fast_window_s),
                                   ("burn_slow", self.slow_window_s)):
                    dg, db = self._window_delta(slo.name, now, win, newest)
                    dt_total = dg + db
                    bad_rate = db / dt_total if dt_total > 0 else 0.0
                    burns[label] = bad_rate / slo.budget
                state = "ok"
                if burns["burn_fast"] > self.threshold:
                    state = ("breach"
                             if burns["burn_slow"] > self.threshold
                             else "warn")
                row = {
                    "kind": slo.kind,
                    "target": slo.target,
                    "budget": slo.budget,
                    "good": good,
                    "bad": bad,
                    "value": (good / total) if total else None,
                    "burn_fast": burns["burn_fast"],
                    "burn_slow": burns["burn_slow"],
                    # the headline single number: the fast window
                    "burn_rate": burns["burn_fast"],
                    "state": state,
                }
                # counter + event fire on the TRANSITION into breach, so
                # the count means breach episodes, not polling frequency
                if state == "breach" and \
                        self._last_state[slo.name] != "breach":
                    if obs.enabled():
                        obs.add(f"slo.breach.{slo.name}")
                    record_event(
                        "slo_breach", site=slo.name, kind=slo.kind,
                        burn_fast=round(burns["burn_fast"], 3),
                        burn_slow=round(burns["burn_slow"], 3),
                        target=slo.target)
                self._last_state[slo.name] = state
                out[slo.name] = row
            return out
