"""Recovery policies (counterpart of ``raft_tpu/resilience/retry.py``):
bounded retries and adaptive OOM degradation.

* :func:`with_retries` — re-invoke a callable verbatim on TRANSIENT
  failures, with bounded exponential backoff. Jitter is seeded and
  deterministic (a hash of ``(seed, attempt)``), the JAX package's
  schedule exactly.
* :func:`degrade_on_oom` — re-invoke a callable that failed with an
  OOM-classified error at half its tile/chunk size, down to a floor.

Every recovery shows twice: obs counters (``resilience.retries.{kind}``,
``resilience.degraded_tile``; no-ops with telemetry off) and a small
always-on event ring (:func:`recent_events`).

Neither executor ever wraps a kernel build or library load: those raise
``ops._native.NativeBuildError``, which classifies FATAL.
"""

from __future__ import annotations

import hashlib
import os
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from raft_tpu_torch import obs
from raft_tpu_torch.resilience.errors import OOM, RETRYABLE, classify as _classify

# ---------------------------------------------------------------------------
# sync mode: surface failures of queued device work INSIDE the recovery scope
# ---------------------------------------------------------------------------

# CUDA work is queued: a kernel's failure can surface at a later
# synchronize, outside any recovery executor. Sync mode forces completion
# inside each degradation attempt. It costs one synchronize per wrapped
# call, so it is OFF by default (RAFT_TPU_RESILIENCE_SYNC=1 turns it on).
# Injected faults raise at the faultpoint and need no sync.
_sync = os.environ.get("RAFT_TPU_RESILIENCE_SYNC", "").strip().lower() in (
    "1", "true", "on", "yes",
)


def sync_mode() -> bool:
    return _sync


def enable_sync() -> None:
    global _sync
    _sync = True


def disable_sync() -> None:
    global _sync
    _sync = False


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _leaves(t)
    else:
        yield tree


def force_completion(tree):
    """Synchronize every CUDA device that holds a tensor in ``tree``
    (nested tuples, lists and dicts) and return ``tree``. A failure of the
    queued work raises here, inside the caller's recovery scope. CPU
    tensors and other leaves need nothing."""
    torch = sys.modules.get("torch")
    if torch is None:
        return tree
    devices = {leaf.device for leaf in _leaves(tree)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree


# ---------------------------------------------------------------------------
# event ring: the lightweight "what degraded?" side-channel
# ---------------------------------------------------------------------------

_EVENTS: deque = deque(maxlen=256)
_EV_LOCK = threading.Lock()


def record_event(event: str, site: str = "", **detail) -> None:
    """Append one structured recovery event (thread-safe, bounded ring).
    Events are timestamped so trace exports (obs/tracing.chrome_trace) can
    place them as instant markers alongside the span timeline."""
    rec = {"event": event, "site": site, "t": round(time.time(), 6), **detail}
    with _EV_LOCK:
        _EVENTS.append(rec)


def recent_events() -> list:
    """Snapshot of the recovery-event ring, oldest first."""
    with _EV_LOCK:
        return list(_EVENTS)


def clear_events() -> None:
    with _EV_LOCK:
        _EVENTS.clear()


# ---------------------------------------------------------------------------
# bounded retry with deterministic backoff
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with seeded jitter.

    ``retry_on`` names the failure kinds eligible for verbatim re-invocation
    (default: TRANSIENT only — OOM goes through :func:`degrade_on_oom`,
    DEADLINE/FATAL always propagate).
    """

    max_retries: int = 3
    base_delay_s: float = 0.1
    max_delay_s: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.25  # ± fraction of the nominal delay
    seed: int = 0
    retry_on: Tuple[str, ...] = RETRYABLE


def _jitter_frac(seed: int, attempt: int) -> float:
    """Deterministic value in [0, 1) from (seed, attempt) — a hash, not a
    clock or global RNG, so the same policy always sleeps the same
    schedule (reproducible benches, replayable failure tests)."""
    h = hashlib.blake2b(f"{seed}:{attempt}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


def backoff_delays(policy: RetryPolicy) -> list:
    """The full delay schedule (seconds) a policy will sleep, attempt by
    attempt — pure function of the policy, exposed for tests."""
    out = []
    for attempt in range(max(0, policy.max_retries)):
        nominal = min(policy.max_delay_s,
                      policy.base_delay_s * policy.multiplier ** attempt)
        frac = _jitter_frac(policy.seed, attempt)  # [0, 1)
        out.append(max(0.0, nominal * (1.0 + policy.jitter * (2.0 * frac - 1.0))))
    return out


def with_retries(
    fn: Callable,
    policy: RetryPolicy = RetryPolicy(),
    *,
    site: str = "",
    classify: Callable = _classify,
    on_retry: Optional[Callable] = None,
    sleep: Callable = time.sleep,
):
    """Invoke ``fn()``; on a retryable-kind failure, back off and retry up
    to ``policy.max_retries`` times. Non-retryable kinds (and exhausted
    budgets) re-raise the original exception unchanged.

    ``on_retry(exc, kind, attempt)`` is called before each sleep; ``sleep``
    is injectable so tests assert the schedule without waiting it out.
    """
    delays = backoff_delays(policy)
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:
            kind = classify(e)
            if kind not in policy.retry_on or attempt >= len(delays):
                raise
            obs.add(f"resilience.retries.{kind}")
            record_event("retry", site=site, kind=kind, attempt=attempt,
                         error=repr(e)[:200])
            if on_retry is not None:
                on_retry(e, kind, attempt)
            sleep(delays[attempt])
            attempt += 1


# ---------------------------------------------------------------------------
# adaptive OOM degradation
# ---------------------------------------------------------------------------


def degrade_on_oom(
    fn: Callable,
    size: int,
    *,
    floor: int = 1,
    factor: int = 2,
    site: str = "",
    classify: Callable = _classify,
):
    """Adaptive degradation executor: call ``fn(size)``; when it fails with
    an OOM-classified error, halve ``size`` (integer ``// factor``) and
    re-invoke, down to ``floor``. At the floor the error propagates — the
    workload genuinely does not fit.

    ``fn`` must be size-idempotent: any ``size`` in [floor, size] yields a
    correct (if differently tiled) result. That holds for every wired site:
    tile and chunk row counts only change the partitioning, never the
    math. Each step is recorded via ``resilience.retries.oom`` /
    ``resilience.degraded_tile`` counters and a ``degraded_tile`` event
    carrying the from→to sizes.

    Under :func:`sync_mode`, each attempt's result is forced to completion
    before the executor returns, so a failure of queued device work is
    recovered here too (off by default: the force is a synchronize per
    call). PyTorch's caching allocator raises an allocation failure at the
    call, so a real CUDA OOM needs no sync to be caught here.
    """
    size = int(size)
    floor = max(1, int(floor))
    while True:
        try:
            out = fn(size)
            if _sync:
                force_completion(out)
            return out
        except Exception as e:
            if classify(e) != OOM or size <= floor:
                raise
        new_size = max(floor, size // max(2, int(factor)))
        obs.add("resilience.retries.oom")
        obs.add("resilience.degraded_tile")
        record_event("degraded_tile", site=site, from_size=size,
                     to_size=new_size)
        size = new_size
