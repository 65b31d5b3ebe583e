"""Cooperative cross-thread cancellation (counterpart of
``raft_tpu/core/interruptible.py``).

Long host-side loops (k-means EM, streamed build chunks, CAGRA build
blocks) call :func:`check_interrupt` between device steps; :func:`cancel`
from another thread raises :class:`InterruptedException` at the next one.
:func:`add_checkpoint` registers extra checks that run at every
:func:`check_interrupt` site: ``resilience.deadline`` uses it, so every
interrupt checkpoint is also a deadline checkpoint without this module
knowing of the resilience layer.
"""

from __future__ import annotations

import threading
from typing import Callable, List

_flags: dict = {}
_lock = threading.Lock()
_checkpoints: List[Callable] = []


class InterruptedException(RuntimeError):
    """Raised at the next check point after :func:`cancel` (named to avoid
    shadowing the builtin InterruptedError, which is an OSError for
    EINTR)."""


def _token(thread_id=None) -> int:
    return thread_id if thread_id is not None else threading.get_ident()


def cancel(thread_id=None) -> None:
    """Request cancellation of ``thread_id`` (default: current thread)."""
    with _lock:
        _flags[_token(thread_id)] = True


def clear(thread_id=None) -> None:
    with _lock:
        _flags.pop(_token(thread_id), None)


def add_checkpoint(fn: Callable) -> None:
    """Register ``fn()`` to run at every :func:`check_interrupt` call
    (idempotent). ``fn`` raises to stop the checkpointed loop."""
    with _lock:
        if fn not in _checkpoints:
            _checkpoints.append(fn)


def check_interrupt() -> None:
    """Raise :class:`InterruptedException` if this thread was cancelled,
    then run the registered checkpoint hooks (deadlines, …)."""
    tid = threading.get_ident()
    with _lock:
        if _flags.pop(tid, False):
            raise InterruptedException(f"thread {tid} interrupted")
        hooks = tuple(_checkpoints)
    for fn in hooks:
        fn()
