"""Deadline propagation (counterpart of
``raft_tpu/resilience/deadline.py``): budget-aware checkpoints for
host-side loops.

Entering a :class:`Deadline` scope makes every
:func:`raft_tpu_torch.core.interruptible.check_interrupt` site a deadline
checkpoint. Two severities:

* ``hard=True`` (default): an expired deadline raises
  :class:`DeadlineExceeded` (classified DEADLINE) at the next checkpoint;
* ``hard=False``: checkpoints never raise; partial-capable sites poll
  :meth:`Deadline.reached` and stop early, calling
  :meth:`Deadline.mark_degraded`, so the scope's owner sees
  ``dl.degraded`` and which sites returned partial results.

Usage::

    from raft_tpu_torch import resilience

    with resilience.Deadline(30.0, hard=False) as dl:
        out = kmeans.fit(X, KMeansParams(n_init=3))
    if dl.degraded:
        ...  # dl.degraded_sites names the loops that cut short
"""

from __future__ import annotations

import math
import threading
import time

from raft_tpu_torch import obs
from raft_tpu_torch.core import interruptible
from raft_tpu_torch.resilience.retry import record_event


class DeadlineExceeded(RuntimeError):
    """Raised at a checkpoint once a hard :class:`Deadline` expires. The
    message carries the ``DEADLINE_EXCEEDED`` token so
    :func:`raft_tpu_torch.resilience.errors.classify` maps it without an import
    cycle."""


_tls = threading.local()


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class Deadline:
    """A wall-clock budget, scoped with ``with`` and consulted at
    checkpoints. Nesting pushes a stack; the innermost scope is the active
    one (an inner scope tighter than its parent behaves as expected; an
    inner scope LOOSER than its parent shadows it — keep inner budgets
    inside outer ones)."""

    def __init__(self, seconds: float, *, hard: bool = True, label: str = ""):
        self.budget_s = float(seconds)
        self.hard = bool(hard)
        self.label = label
        self.degraded = False
        self.degraded_sites: list = []
        self._t_end: float = math.inf

    # -- scope --------------------------------------------------------------
    def __enter__(self) -> "Deadline":
        self._t_end = time.monotonic() + self.budget_s
        _stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # unbalanced exit: still remove ourselves
            stack.remove(self)
        return False

    # -- queries ------------------------------------------------------------
    def remaining(self) -> float:
        """Seconds left (+inf before the scope is entered)."""
        return self._t_end - time.monotonic()

    def reached(self) -> bool:
        return self.remaining() <= 0.0

    def check(self) -> None:
        """Raise :class:`DeadlineExceeded` if the budget is spent."""
        if self.reached():
            raise DeadlineExceeded(
                f"DEADLINE_EXCEEDED: {self.label or 'deadline'} budget "
                f"{self.budget_s:g}s spent")

    # -- partial-result marker ----------------------------------------------
    def mark_degraded(self, site: str) -> None:
        """A checkpointed loop cut itself short at ``site`` and is returning
        partial/degraded results under this deadline."""
        self.degraded = True
        self.degraded_sites.append(site)
        obs.add("resilience.deadline.partial")
        record_event("deadline_partial", site=site,
                     label=self.label, budget_s=self.budget_s)


def active_deadline():
    """The innermost active :class:`Deadline` of this thread, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def check_deadline() -> None:
    """Checkpoint: raise :class:`DeadlineExceeded` when the active deadline
    is hard and spent. Soft deadlines never raise here — partial-capable
    sites poll :meth:`Deadline.reached` themselves."""
    dl = active_deadline()
    if dl is not None and dl.hard:
        dl.check()


# every existing check_interrupt() site becomes a deadline checkpoint
interruptible.add_checkpoint(check_deadline)
