"""Deterministic fault injection (counterpart of
``raft_tpu/resilience/faultinject.py``): named sites, armed by env or API.

Hot paths carry ``faultpoint("site.name")`` markers that, when armed,
raise a simulated failure of a chosen class on a chosen hit. Disarmed cost
is one global read and one truthiness check.

Arming grammar (``RAFT_TPU_FAULTS`` env var, or :func:`arm_faults`), the
JAX package's::

    RAFT_TPU_FAULTS="site=kind[:count[:arg]][,site2=kind2...]"

    kind    one of  oom | transient | fatal | delay | hang
    count   how many hits fire, starting from the first (default 1)
    arg     delay = seconds to sleep (default 0.05),
            hang = max seconds to hang (safety cap, default 300)

``oom`` raises with a ``RESOURCE_EXHAUSTED`` message and ``transient``
with ``UNAVAILABLE``, so :func:`raft_tpu_torch.resilience.errors.classify`
routes them like the real thing. ``hang`` spins on
:func:`~raft_tpu_torch.core.interruptible.check_interrupt`, so a hard
:class:`~raft_tpu_torch.resilience.deadline.Deadline` ends it.

Site names are the JAX package's: ``<module>.<entry>[.<phase>]``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

from raft_tpu_torch import obs
from raft_tpu_torch.core.interruptible import check_interrupt
from raft_tpu_torch.resilience.retry import record_event

ENV_VAR = "RAFT_TPU_FAULTS"

_KINDS = ("oom", "transient", "fatal", "delay", "hang")
_DEFAULT_ARGS = {"delay": 0.05, "hang": 300.0}


class FaultInjected(RuntimeError):
    """A simulated failure raised by an armed :func:`faultpoint`."""


class _Fault:
    __slots__ = ("kind", "remaining", "arg")

    def __init__(self, kind: str, remaining: int, arg: float):
        self.kind = kind
        self.remaining = remaining
        self.arg = arg


# None = env not parsed yet; {} = parsed, nothing armed (the common case)
_SITES: Optional[Dict[str, _Fault]] = None
_LOCK = threading.Lock()


def _parse(spec: str) -> Dict[str, _Fault]:
    table: Dict[str, _Fault] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        site, sep, rhs = entry.partition("=")
        site = site.strip()
        if not sep or not site:
            raise ValueError(f"bad fault entry {entry!r}: want site=kind[:count[:arg]]")
        parts = rhs.strip().split(":")
        kind = parts[0]
        if kind not in _KINDS:
            raise ValueError(f"bad fault kind {kind!r} (known: {', '.join(_KINDS)})")
        count = int(parts[1]) if len(parts) > 1 and parts[1] else 1
        arg = (float(parts[2]) if len(parts) > 2 and parts[2]
               else _DEFAULT_ARGS.get(kind, 0.0))
        table[site] = _Fault(kind, count, arg)
    return table


def arm_faults(spec: str) -> None:
    """Arm faults programmatically (same grammar as the env var)."""
    global _SITES
    with _LOCK:
        _SITES = _parse(spec)


def clear_faults() -> None:
    """Disarm everything (also forgets any env-derived arming)."""
    global _SITES
    with _LOCK:
        _SITES = {}


def reset() -> None:
    """Forget the cached table; the next :func:`faultpoint` re-reads
    ``RAFT_TPU_FAULTS`` (tests that set the env var call this)."""
    global _SITES
    with _LOCK:
        _SITES = None


def armed_sites() -> Dict[str, tuple]:
    """{site: (kind, remaining)} of currently-armed faults (diagnostics)."""
    with _LOCK:
        table = _SITES or {}
        return {s: (f.kind, f.remaining) for s, f in table.items()}


def _fire(site: str, fault: _Fault) -> None:
    obs.add(f"resilience.faults.{fault.kind}")
    record_event("fault_injected", site=site, kind=fault.kind)
    if fault.kind == "oom":
        raise FaultInjected(
            f"RESOURCE_EXHAUSTED: injected oom at faultpoint {site!r}")
    if fault.kind == "transient":
        raise FaultInjected(
            f"UNAVAILABLE: injected transient fault at faultpoint {site!r}")
    if fault.kind == "fatal":
        raise FaultInjected(f"injected fatal fault at faultpoint {site!r}")
    if fault.kind == "delay":
        time.sleep(fault.arg)
        return
    # hang: spin on the cooperative checkpoint — a hard Deadline (or a
    # cross-thread cancel) raises out of check_interrupt; the cap bounds
    # the un-deadlined case so a misconfigured test cannot wedge tier-1
    t0 = time.monotonic()
    while time.monotonic() - t0 < fault.arg:
        check_interrupt()
        time.sleep(0.02)
    raise FaultInjected(
        f"injected hang at faultpoint {site!r} hit its {fault.arg:g}s cap "
        f"with no deadline/interrupt — timed out")


def faultpoint(site: str) -> None:
    """Named injection site. No-op (one global read + truthiness check)
    unless :data:`ENV_VAR` / :func:`arm_faults` armed a fault for exactly
    this site name, in which case the armed behavior fires on each of its
    first ``count`` hits."""
    global _SITES
    table = _SITES
    if table is None:
        with _LOCK:
            if _SITES is None:
                _SITES = _parse(os.environ.get(ENV_VAR, ""))
            table = _SITES
    if not table:
        return
    fault = table.get(site)
    if fault is None:
        return
    with _LOCK:
        if fault.remaining <= 0:
            return
        fault.remaining -= 1
    _fire(site, fault)
