"""Offline frontier tuner (counterpart of ``raft_tpu/tuning/autotune.py``):
diagnosis-driven knob moves, not grid search.

The propose → serve-window → read-record loop: each iteration serves one
traffic window on a live ``QueryQueue``/store under the CURRENT knob
vector (every window is a flight-recorder fingerprint —
:func:`raft_tpu_torch.obs.flight.fingerprint`), reads the window's
obs-report record back, runs the attribution engine
(:func:`raft_tpu_torch.obs.explain.explain`) and maps the top diagnosis to
ONE knob move through an explicit :data:`RULE_TABLE` — ``mxu_underfill`` →
raise the batch cap, ``hbm_bound`` → lower ``bits``/switch engine,
``recall_limited`` → raise ``n_probes``/``k_fetch`` — instead of walking
a hand-written sweep grid. Because every move is justified by a
diagnosis, the whole tuning episode is reconstructible: each window
record carries its explain record and the proposal it produced. On the
card the searches a window serves run the port's kernels (a paged flat
store's scan is K3, ``ops/csrc/paged_scan.cu``).

Accumulated windows feed ``flight.extract_frontier`` (the same Pareto
fold the flight CLI runs), and :meth:`Autotuner.emit_operating_point`
writes the frontier point that meets a stated SLO — highest QPS subject
to the p99 bound and recall floor — as a JSON config
(``RAFT_TPU_TUNE_OPERATING_POINT``, default
``results/operating_point.json``, the JAX package's schema) that serving
entry points consume via :func:`load_operating_point`.

Each window is deadline-bounded (``RAFT_TPU_TUNE_DEADLINE_S``, through
``resilience.Deadline``) and faultpointed (``tuning.autotune.window``): an
armed fault skips THAT window classified (counted, event-ringed) and the
next window proceeds — a tuner that dies on one bad window would be worse
than no tuner.

Telemetry-off contract: a disabled registry means the tuner holds ZERO
state (the flight-recorder NOOP gate); ``step()``/``run()`` return None.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Optional

from raft_tpu_torch import obs, resilience
from raft_tpu_torch.resilience.retry import record_event

__all__ = [
    "DEADLINE_ENV",
    "MAX_WINDOWS_ENV",
    "OPERATING_POINT_ENV",
    "RULE_TABLE",
    "Autotuner",
    "Knob",
    "default_operating_point_path",
    "default_tune_deadline",
    "default_tune_windows",
    "load_operating_point",
]

#: operating_point record schema
SCHEMA_VERSION = 1

MAX_WINDOWS_ENV = "RAFT_TPU_TUNE_MAX_WINDOWS"
OPERATING_POINT_ENV = "RAFT_TPU_TUNE_OPERATING_POINT"
DEADLINE_ENV = "RAFT_TPU_TUNE_DEADLINE_S"

_DEFAULT_MAX_WINDOWS = 16
_DEFAULT_DEADLINE_S = 30.0
_DEFAULT_OPERATING_POINT = os.path.join("results", "operating_point.json")

#: diagnosis kind → ordered (knob, step) candidates; the FIRST candidate
#: whose knob exists in the tuner's knob set and has headroom wins, so one
#: table serves ivf_flat (no ``bits``) and ivf_bq (no ``k_fetch``) alike.
#: ``retrace_tax``/``unknown`` map to NO move: a retrace or a blind window
#: is a bug to fix, not a knob to turn — the tuner holds and re-measures.
RULE_TABLE = {
    "mxu_underfill": (("batch_cap", +1), ("q_block", +1)),
    "queue_limited": (("batch_cap", +1),),
    "padding_waste": (("batch_cap", +1), ("page_rows", +1)),
    "hbm_bound": (("bits", -1), ("engine", +1), ("n_probes", -1)),
    "capacity_limited": (("bits", -1), ("page_rows", -1)),
    "recall_limited": (("n_probes", +1), ("k_fetch", +1)),
    "retrace_tax": (),
    "unknown": (),
}


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


def default_tune_windows() -> int:
    """Offline window budget per :meth:`Autotuner.run`
    (``RAFT_TPU_TUNE_MAX_WINDOWS``, default 16)."""
    return _env_int(MAX_WINDOWS_ENV, _DEFAULT_MAX_WINDOWS)


def default_tune_deadline() -> float:
    """Per-window wall-clock bound in seconds
    (``RAFT_TPU_TUNE_DEADLINE_S``, default 30)."""
    return _env_float(DEADLINE_ENV, _DEFAULT_DEADLINE_S)


def default_operating_point_path() -> str:
    """Where the tuned operating point lands and is looked up
    (``RAFT_TPU_TUNE_OPERATING_POINT``, default
    ``results/operating_point.json``)."""
    raw = os.environ.get(OPERATING_POINT_ENV, "").strip()
    return raw or _DEFAULT_OPERATING_POINT


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


class Knob:
    """One tunable: a name and an ORDERED ladder of candidate values
    (ascending cost/quality — ``up`` means a later rung). The ladder is
    explicit so every move lands on a value someone chose, never an
    extrapolation; values must be JSON-serializable (they feed the
    config fingerprint)."""

    def __init__(self, name: str, values, start=None):
        self.name = str(name)
        self.values = list(values)
        if not self.values:
            raise ValueError(f"knob {name!r} has an empty ladder")
        if start is None:
            self.idx = 0
        else:
            if start not in self.values:
                raise ValueError(
                    f"knob {name!r} start {start!r} not on its ladder")
            self.idx = self.values.index(start)

    @property
    def value(self):
        return self.values[self.idx]

    def can(self, step: int) -> bool:
        return step != 0 and 0 <= self.idx + step < len(self.values)

    def apply(self, step: int):
        """Move one rung; returns (frm, to)."""
        frm = self.value
        self.idx += int(step)
        self.idx = max(0, min(len(self.values) - 1, self.idx))
        return frm, self.value


class Autotuner:
    """Diagnosis-driven offline tuner over one serving setup.

    ``serve_fn(knob_values: dict) -> dict`` serves ONE traffic window
    under the given knob vector and returns the window record — a
    ``flight_window``-shaped dict carrying at least ``report`` (an
    ``obs.report.collect()`` record) and ``ops`` (window-local
    ``qps``/``p99_ub_s``); a ``FlightRecorder.sample()`` return value is
    exactly right. ``knobs`` is a list of :class:`Knob`. ``slo`` is the
    target the run converges toward and the emitted point must meet:
    ``{"p99_s": float, "recall_floor": float, "qps_min": float}`` (every
    field optional). ``path`` (optional) streams each tuner window
    crash-safe through ``bench/progress``.

    Convergence: a window that meets the SLO and produces no applicable
    move (healthy, or its knob at a ladder bound) increments a hold
    streak; ``settle`` consecutive holds end :meth:`run` early.
    """

    def __init__(self, serve_fn, knobs, *, slo: Optional[dict] = None,
                 rules: Optional[dict] = None,
                 max_windows: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 settle: int = 2,
                 path: Optional[str] = None):
        self._enabled = obs.enabled()
        if not self._enabled:
            return  # telemetry off ⇒ ZERO tuner state (the NOOP contract)
        self._serve_fn = serve_fn
        self._knobs = {k.name: k for k in knobs}
        if not self._knobs:
            raise ValueError("Autotuner needs at least one knob")
        self._slo = dict(slo) if slo else {}
        self._rules = dict(rules) if rules is not None else dict(RULE_TABLE)
        self._max_windows = int(max_windows if max_windows is not None
                                else default_tune_windows())
        self._deadline_s = float(deadline_s if deadline_s is not None
                                 else default_tune_deadline())
        self._settle = max(1, int(settle))
        self._path = path
        self._windows: list = []
        self._prev_report: Optional[dict] = None
        self._window_id = 0
        self._skipped = 0
        self._moves = 0
        self._holds = 0
        self._hold_streak = 0
        self._converged = False

    # -- state --------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def converged(self) -> bool:
        return self._enabled and self._converged

    def knob_values(self) -> dict:
        """The CURRENT knob vector — what serve_fn is handed, and what a
        co-wired FlightRecorder should fingerprint."""
        if not self._enabled:
            return {}
        return {name: k.value for name, k in self._knobs.items()}

    def windows(self) -> list:
        """Accumulated (non-skipped) window records, oldest first."""
        return list(self._windows) if self._enabled else []

    def stats(self) -> dict:
        if not self._enabled:
            return {}
        return {
            "windows": len(self._windows),
            "skipped": self._skipped,
            "moves": self._moves,
            "holds": self._holds,
            "converged": self._converged,
            "knobs": self.knob_values(),
        }

    # -- the loop -----------------------------------------------------------
    def step(self) -> Optional[dict]:
        """One propose → serve → read → move iteration. Returns the
        window record (with its ``explain`` and ``proposal`` attached),
        or a classified ``{"status": kind}`` stub when an armed fault /
        deadline skipped the window, or None when disabled."""
        if not self._enabled:
            return None
        values = self.knob_values()
        wid = self._window_id
        self._window_id += 1
        try:
            with obs.record_span("tuning::window",
                                 attrs={"window": wid}):
                with resilience.Deadline(self._deadline_s,
                                         label="tuning.autotune"):
                    # faultpoint INSIDE the deadline scope: an armed hang
                    # spins on check_interrupt and is bounded by the
                    # window deadline, not the fault's own safety cap
                    resilience.faultpoint("tuning.autotune.window")
                    rec = dict(self._serve_fn(dict(values)) or {})
                    rec = self._fold_window(rec, wid, values)
        except Exception as e:
            kind = resilience.classify(e)
            self._skipped += 1
            obs.add(f"tuning.window.{kind.lower()}")
            record_event("tuning.window_skipped", kind=kind, window=wid,
                         error=repr(e)[:200])
            return {"status": kind, "window": wid}
        self._windows.append(rec)
        self._export(rec)
        return rec

    def _fold_window(self, rec: dict, wid: int, values: dict) -> dict:
        """Stamp fingerprint/explain/proposal onto one served window and
        apply the proposal's knob move."""
        from raft_tpu_torch.obs import explain as obs_explain
        from raft_tpu_torch.obs import flight

        rec.setdefault("type", "flight_window")
        rec.setdefault("t", round(time.time(), 3))
        rec["tuner_window"] = wid
        # the PROPOSAL is ground truth for the frontier grouping — a
        # recorder wired to stale knobs must not split the groups
        rec["fingerprint"] = flight.fingerprint(values)
        report = rec.get("report")
        if isinstance(report, dict) and report.get("type") == "obs_report":
            diag = obs_explain.explain(report, prev=self._prev_report)
            self._prev_report = report
        else:
            # a window with no readable report can only be unknown —
            # classified in the record, never a crash
            diag = {"type": "explain",
                    "schema_version": obs_explain.SCHEMA_VERSION,
                    "window": wid, "pressure": {}, "healthy": False,
                    "primary": "unknown",
                    "diagnoses": [{"kind": "unknown", "score": 0.5,
                                   "evidence": {"missing": "report"}}]}
        rec["explain"] = diag
        rec["proposal"] = self._propose(diag, rec)
        return rec

    def _propose(self, diag: dict, rec: dict) -> dict:
        """Map the top diagnosis to one knob move via the rule table and
        APPLY it (the next window serves the moved vector)."""
        primary = diag.get("primary")
        meets = self._meets_slo(rec)
        out = {"diagnosis": primary, "meets_slo": meets}
        knob = step = None
        for name, s in self._rules.get(primary, ()) if primary else ():
            cand = self._knobs.get(name)
            if cand is not None and cand.can(s):
                knob, step = cand, s
                break
        if knob is None:
            self._holds += 1
            out["move"] = None
            out["reason"] = ("healthy" if primary is None
                            else "no_applicable_knob")
            if meets:
                self._hold_streak += 1
                if self._hold_streak >= self._settle:
                    self._converged = True
            else:
                self._hold_streak = 0
            return out
        frm, to = knob.apply(step)
        self._moves += 1
        self._hold_streak = 0
        out["move"] = {"knob": knob.name, "frm": frm, "to": to}
        obs.add("tuning.moves")
        record_event("tuning.propose", knob=knob.name, frm=frm, to=to,
                     diagnosis=primary)
        return out

    def run(self, max_windows: Optional[int] = None) -> dict:
        """Loop :meth:`step` until convergence or the window budget.
        Returns :meth:`stats` (empty dict when disabled)."""
        if not self._enabled:
            return {}
        budget = int(max_windows if max_windows is not None
                     else self._max_windows)
        for _ in range(budget):
            self.step()
            if self._converged:
                break
        return self.stats()

    # -- SLO ----------------------------------------------------------------
    def _meets_slo(self, rec: dict) -> bool:
        """Does this window's operating point meet the stated SLO? A
        missing measurement FAILS the bound it was needed for (absence
        of evidence is not compliance)."""
        ops = rec.get("ops") or {}
        slo = self._slo
        p99 = slo.get("p99_s")
        if _finite(p99) and not (_finite(ops.get("p99_ub_s"))
                                 and ops["p99_ub_s"] <= p99):
            return False
        qps_min = slo.get("qps_min")
        if _finite(qps_min) and not (_finite(ops.get("qps"))
                                     and ops["qps"] >= qps_min):
            return False
        floor = slo.get("recall_floor")
        if _finite(floor):
            report = rec.get("report") if isinstance(rec.get("report"),
                                                     dict) else {}
            est = report.get("recall")
            if not (isinstance(est, dict) and _finite(est.get("recall"))
                    and est["recall"] >= floor):
                return False
        return True

    # -- frontier + operating point -----------------------------------------
    def frontier(self) -> dict:
        """Pareto frontier over the accumulated windows — the same
        ``flight.extract_frontier`` fold the flight CLI runs."""
        from raft_tpu_torch.obs import flight

        if not self._enabled:
            return {"points": 0, "pareto_points": 0, "groups": []}
        return flight.extract_frontier(self._windows)

    def emit_operating_point(self, slo: Optional[dict] = None,
                             path: Optional[str] = None) -> Optional[dict]:
        """Pick the frontier point that meets ``slo`` (default: the run's
        SLO) with the highest QPS and write it as the operating-point
        JSON (``path`` default: :func:`default_operating_point_path`).
        When NO point meets the SLO the best Pareto point still lands,
        stamped ``meets_slo: false`` — a consumer can refuse it, but the
        episode's outcome is on disk either way. Returns the emitted
        record, or None when disabled/empty."""
        if not self._enabled:
            return None
        with obs.record_span("tuning::emit_operating_point"):
            return self._emit(slo if slo is not None else self._slo,
                              path or default_operating_point_path())

    def _emit(self, slo: dict, path: str) -> Optional[dict]:
        front = self.frontier()
        groups = [g for g in front.get("groups") or [] if g.get("pareto")]
        if not groups:
            return None

        def meets(g: dict) -> bool:
            p99 = slo.get("p99_s")
            if _finite(p99) and not (_finite(g.get("p99_ub_s"))
                                     and g["p99_ub_s"] <= p99):
                return False
            qps_min = slo.get("qps_min")
            if _finite(qps_min) and not (_finite(g.get("qps"))
                                         and g["qps"] >= qps_min):
                return False
            floor = slo.get("recall_floor")
            if _finite(floor) and not (_finite(g.get("recall"))
                                       and g["recall"] >= floor):
                return False
            return True

        eligible = [g for g in groups if meets(g)]
        pool = eligible or groups
        best = max(pool, key=lambda g: (g.get("qps") or 0.0,
                                        g.get("recall") or 0.0))
        doc = {
            "t": round(time.time(), 3),
            "type": "operating_point",
            "schema_version": SCHEMA_VERSION,
            "tuned_by": "raft_tpu_torch.tuning.autotune",
            "fp": best["fp"],
            "knobs": dict(best.get("knobs") or {}),
            "slo": dict(slo),
            "meets_slo": bool(eligible),
            "qps": best.get("qps"),
            "p99_ub_s": best.get("p99_ub_s"),
            "recall": best.get("recall"),
            "windows": len(self._windows),
            "skipped": self._skipped,
            "moves": self._moves,
            "pareto_points": front.get("pareto_points"),
        }
        from raft_tpu_torch.bench import progress

        progress.write_artifact(path, doc)
        obs.add("tuning.operating_points")
        record_event("tuning.operating_point", fp=best["fp"],
                     meets_slo=doc["meets_slo"], qps=doc["qps"])
        return doc

    def _export(self, rec: dict) -> None:
        if not self._path:
            return
        try:
            from raft_tpu_torch.bench import progress

            progress.export_metrics(self._path, rec)
        except Exception as e:
            resilience.classify(e)
            obs.add("tuning.export_degraded")


def load_operating_point(path: Optional[str] = None) -> Optional[dict]:
    """Read a previously emitted operating point; None when absent,
    unreadable, or not an operating_point record — the caller's fallback-
    to-defaults path, never a crash."""
    path = path or default_operating_point_path()
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("type") != "operating_point" \
            or not isinstance(doc.get("knobs"), dict):
        return None
    return doc
