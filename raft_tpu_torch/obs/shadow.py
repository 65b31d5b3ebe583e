"""Online recall estimation (counterpart of ``raft_tpu/obs/shadow.py``):
shadow-sample served queries off the hot path.

Recall is the one serving SLO that, until now, only existed offline — bench
runs measure it against precomputed ground truth, but a live index that
drifts (upserts, deletes, a lost shard) degrades recall silently. The
:class:`ShadowSampler` closes that gap the way serving systems do: a
**deterministic, seeded** fraction of served queries
(``RAFT_TPU_OBS_SHADOW_RATE``) is re-run through an exact search
*off the hot path* — background thread, bounded queue, drop-on-pressure —
and each shadow result scores the served top-k against the exact top-k.
The running ``(matched, total)`` slot counts feed a live recall@k estimate
with a Wilson binomial confidence interval, which is exactly the shape the
recall SLO burn rate (obs/slo.py) consumes.

Failure contract: the shadow path must never block
or fail a serving request. ``offer()`` is the only hot-path touch — one
seeded-hash decision and, for sampled queries, one bounded-deque append
(full queue ⇒ drop, counted). The worker runs each exact search under a
hard :class:`~raft_tpu_torch.resilience.Deadline` behind the
``obs.shadow.search`` faultpoint; any failure is routed through
``resilience.classify`` into a ``shadow_error`` event and the estimate
degrades to **stale** until the next successful sample.

Sampling decisions hash ``(seed, sequence_number)`` (the resilience
backoff-jitter pattern — no wall clock, no global RNG), so the sampled
subset is reproducible for tests and replayable across runs.
"""

from __future__ import annotations

import hashlib
import math
import os
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from raft_tpu_torch import obs, resilience
from raft_tpu_torch.resilience.retry import record_event

__all__ = ["RATE_ENV", "ShadowSampler", "sample_decision", "wilson_interval"]

RATE_ENV = "RAFT_TPU_OBS_SHADOW_RATE"

#: z for the 95% Wilson interval
_Z95 = 1.959963984540054


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if hasattr(x, "cpu"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def default_rate() -> float:
    """The shadow fraction from ``RAFT_TPU_OBS_SHADOW_RATE`` (0 disables;
    values clamp into [0, 1]; unset/garbage ⇒ 0)."""
    raw = os.environ.get(RATE_ENV, "").strip()
    try:
        return min(1.0, max(0.0, float(raw))) if raw else 0.0
    except ValueError:
        return 0.0


def sample_decision(seed: int, seq: int, rate: float) -> bool:
    """Deterministic Bernoulli(rate) draw for the ``seq``-th offer: a
    blake2b hash of ``(seed, seq)`` mapped to [0, 1) — the same
    no-clock/no-global-RNG determinism contract as the retry jitter."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    h = hashlib.blake2b(f"{seed}:{seq}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64 < rate


def wilson_interval(matched: int, total: int) -> tuple:
    """(low, high) 95% Wilson score interval for a binomial proportion —
    well-behaved at the boundaries (recall 1.0 with few samples gets a
    wide, honest interval instead of [1, 1])."""
    if total <= 0:
        return (0.0, 1.0)
    p = matched / total
    z2 = _Z95 * _Z95
    denom = 1.0 + z2 / total
    center = (p + z2 / (2.0 * total)) / denom
    half = (_Z95 * math.sqrt(p * (1.0 - p) / total
                             + z2 / (4.0 * total * total))) / denom
    # the interval must CONTAIN the point estimate; at the boundaries the
    # exact bound equals p and float rounding can land a hair inside it
    low = max(0.0, min(center - half, p))
    high = min(1.0, max(center + half, p))
    return (low, high)


class ShadowSampler:
    """Re-run a seeded fraction of served queries through exact search and
    keep a live recall@k estimate.

    ``exact_fn(queries_2d) -> (vals, ids)`` is the exact reference — for a
    paged store, the store's own scan at ``n_probes = n_lists`` (exact over
    the *current* corpus, so upserted rows are scored fairly); for a static
    index, a brute-force closure.

    Drive it with the background worker (:meth:`start`/:meth:`stop`) in
    serving, or synchronously (:meth:`pump`) in deterministic tests.
    """

    def __init__(self, exact_fn: Callable, *, k: int,
                 rate: Optional[float] = None, seed: int = 0,
                 max_pending: int = 64, timeout_s: float = 30.0):
        self._exact_fn = exact_fn
        self.k = int(k)
        self.rate = default_rate() if rate is None else \
            min(1.0, max(0.0, float(rate)))
        self.seed = int(seed)
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._pending: deque = deque()  # guarded-by: _lock
        self._max_pending = max(1, int(max_pending))
        self._seq = 0      # guarded-by: _lock
        self._matched = 0  # guarded-by: _lock
        self._total = 0    # guarded-by: _lock
        self._samples = 0  # guarded-by: _lock
        self._dropped = 0  # guarded-by: _lock
        self._errors = 0   # guarded-by: _lock
        self._stale = True  # guarded-by: _lock -- no data yet: stale until the first sample
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- hot-path side ------------------------------------------------------
    def offer(self, query, served_ids, trace_id: Optional[str] = None) -> bool:
        """Hot-path entry: decide (seeded hash), enqueue or drop. Returns
        True when the query was enqueued for shadowing. Never blocks, never
        raises past the decision: a full queue drops the sample (counted),
        never delays the request."""
        with self._lock:
            seq = self._seq
            self._seq += 1
            if not sample_decision(self.seed, seq, self.rate):
                return False
            if len(self._pending) >= self._max_pending:
                self._dropped += 1
                drop = True
            else:
                self._pending.append(
                    (_host(query).astype(np.float32).reshape(1, -1),
                     _host(served_ids).reshape(-1), trace_id))
                drop = False
        if obs.enabled():
            obs.add("obs.shadow.dropped" if drop else "obs.shadow.offered")
        return not drop

    # -- shadow side --------------------------------------------------------
    def _score(self, item) -> None:
        query, served, trace_id = item
        with obs.record_span("obs.shadow::search",
                             attrs={"trace_id": trace_id}
                             if obs.enabled() else None):
            resilience.faultpoint("obs.shadow.search")
            # hard deadline: a hung exact search
            # must cost the shadow sample, never wedge the worker
            with resilience.Deadline(self.timeout_s, label="obs.shadow"):
                _, exact_ids = self._exact_fn(query)
        exact = set(int(i) for i in _host(exact_ids).reshape(-1)[:self.k]
                    if int(i) >= 0)
        got = [int(i) for i in served[:self.k] if int(i) >= 0]
        matched = sum(1 for i in got if i in exact)
        total = max(len(exact), 1)
        with self._lock:
            self._matched += matched
            self._total += total
            self._samples += 1
            self._stale = False
        if obs.enabled():
            obs.add("obs.shadow.samples")
            obs.add("obs.shadow.slots", total)
            obs.add("obs.shadow.slot_misses", total - matched)
            est = self.estimate()
            if est["recall"] is not None:
                obs.set_gauge("obs.shadow.recall", est["recall"])

    def pump(self) -> bool:
        """Process ONE queued shadow sample synchronously; True when there
        was one. The deterministic test/bench entry — same scoring path as
        the worker, including the stale-on-failure contract."""
        with self._lock:
            item = self._pending.popleft() if self._pending else None
        if item is None:
            return False
        try:
            self._score(item)
        except Exception as e:
            # never propagate: a shadow failure costs the estimate its
            # freshness, classified, and nothing else
            kind = resilience.classify(e)
            with self._lock:
                self._errors += 1
                self._stale = True
            if obs.enabled():
                obs.add(f"obs.shadow.errors.{kind}")
            record_event("shadow_error", site="obs.shadow.search",
                         kind=kind, error=repr(e)[:200])
        return True

    def drain(self, timeout_s: float = 30.0) -> None:
        """Pump until the queue is empty (worker running or not)."""
        t_end = time.monotonic() + timeout_s
        while time.monotonic() < t_end:
            with self._lock:
                empty = not self._pending
            if empty:
                return
            if self._worker is None or not self._worker.is_alive():
                self.pump()
            else:
                time.sleep(1e-3)

    # -- worker -------------------------------------------------------------
    def start(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        self._stop.clear()
        self._worker = threading.Thread(
            target=self._run, name="raft-tpu-shadow", daemon=True)
        self._worker.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            if not self.pump():
                self._stop.wait(timeout=5e-3)

    def stop(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        if drain:
            self.drain(timeout_s=timeout_s)
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
            self._worker = None

    # -- estimate -----------------------------------------------------------
    def counts(self) -> tuple:
        """Cumulative ``(matched, total)`` shadow slot counts — the
        good/bad source the recall SLO burn rate consumes."""
        with self._lock:
            return self._matched, self._total

    def estimate(self) -> dict:
        """Live recall estimate: ``{"recall", "ci_low", "ci_high",
        "samples", "slots", "dropped", "errors", "stale"}``. ``recall`` is
        None until the first successful sample; ``stale`` is True then and
        after any classified shadow failure (cleared by the next success).
        """
        with self._lock:
            matched, total = self._matched, self._total
            samples, dropped = self._samples, self._dropped
            errors, stale = self._errors, self._stale
        low, high = wilson_interval(matched, total)
        return {
            "recall": matched / total if total else None,
            "ci_low": low if total else 0.0,
            "ci_high": high if total else 1.0,
            "samples": samples,
            "slots": total,
            "dropped": dropped,
            "errors": errors,
            "stale": stale,
        }
