"""Failure classification (counterpart of ``raft_tpu/resilience/errors.py``):
every recovery decision routes through one table.

:func:`classify` maps a raw exception to one of four kinds:

* ``OOM``       — device or host allocation failure: retryable at a
  REDUCED size (``retry.degrade_on_oom``);
* ``TRANSIENT`` — connection resets, unavailable or aborted runtime states,
  interrupted syscalls: retryable as-is with backoff;
* ``DEADLINE``  — budget expiry (``subprocess.TimeoutExpired``, the
  resilience ``Deadline``, cooperative interrupts): not retried inside the
  expired scope;
* ``FATAL``     — everything else: never retried.

Classification is type first, then message pattern, then the
``__cause__`` chain. The card's failures, as the port meets them:

* ``torch.cuda.OutOfMemoryError`` (also ``torch.OutOfMemoryError``) →
  OOM, by type;
* a ``RuntimeError`` reading "CUDA error: out of memory" → OOM, by its
  message;
* a kernel launch that returned ``cudaErrorMemoryAllocation`` → OOM: the
  wrappers' launch errors carry "out of memory" (``ops/_native.
  launch_message``);
* everything ``ops/_native`` raises when ``nvcc`` fails or is missing or a
  library will not load is a ``NativeBuildError`` → FATAL, by type and
  whatever the compiler printed, so no retry ever re-runs a kernel that
  failed to build.
"""

from __future__ import annotations

import subprocess

from raft_tpu_torch.core.interruptible import InterruptedException

#: the four failure kinds (values are the spelling used in obs counter
#: names: ``resilience.retries.oom``, …)
OOM = "oom"
TRANSIENT = "transient"
DEADLINE = "deadline"
FATAL = "fatal"

KINDS = (OOM, TRANSIENT, DEADLINE, FATAL)

#: kinds that with_retries may retry as-is (OOM retries only through the
#: size-reducing degradation executor, never verbatim)
RETRYABLE = (TRANSIENT,)

# message patterns, matched case-insensitively against str(exc). Order
# matters: OOM outranks DEADLINE outranks TRANSIENT. PyTorch's
# "CUDA out of memory. Tried to allocate …" and the runtime's "CUDA error:
# out of memory" both match "out of memory".
_OOM_PATTERNS = (
    "resource_exhausted",
    "resource exhausted",
    "out of memory",
    "out_of_memory",
    "allocation failure",
    "failed to allocate",
    "hbm limit",
)
_DEADLINE_PATTERNS = (
    "deadline_exceeded",
    "deadline exceeded",
    "timed out",
    "timeout",
)
_TRANSIENT_PATTERNS = (
    "unavailable",
    "aborted",
    "connection reset",
    "connection refused",
    "connection closed",
    "broken pipe",
    "socket closed",
    "temporarily unavailable",
    "try again",
    "transient",
)

# exception type NAMES matched without importing their defining modules
_DEADLINE_TYPE_NAMES = {"DeadlineExceeded", "TimeoutExpired", "TimeoutError"}
# torch.cuda.OutOfMemoryError (torch.OutOfMemoryError is the same class)
_OOM_TYPE_NAMES = {"OutOfMemoryError"}
# a kernel that failed to build or load: FATAL whatever its text says
_FATAL_TYPE_NAMES = {"NativeBuildError"}


def _classify_one(exc: BaseException) -> str:
    """Classify one exception, ignoring its cause chain."""
    name = type(exc).__name__
    if name in _FATAL_TYPE_NAMES:
        return FATAL
    if isinstance(exc, MemoryError) or name in _OOM_TYPE_NAMES:
        return OOM
    if isinstance(exc, (subprocess.TimeoutExpired, TimeoutError)):
        return DEADLINE
    if isinstance(exc, InterruptedException):
        # a cooperative cancel is a budget decision by another thread
        return DEADLINE
    if isinstance(exc, ConnectionError):  # reset / refused / broken pipe
        return TRANSIENT
    if isinstance(exc, InterruptedError):  # EINTR
        return TRANSIENT
    if name in _DEADLINE_TYPE_NAMES:
        return DEADLINE
    msg = str(exc).lower()
    if any(p in msg for p in _OOM_PATTERNS):
        return OOM
    if any(p in msg for p in _DEADLINE_PATTERNS):
        return DEADLINE
    if any(p in msg for p in _TRANSIENT_PATTERNS):
        return TRANSIENT
    return FATAL


def classify(exc: BaseException) -> str:
    """Map ``exc`` to ``OOM | TRANSIENT | DEADLINE | FATAL``.

    Walks a bounded ``__cause__`` chain so an explicitly wrapped OOM
    (``raise X from oom``) still classifies as OOM. The implicit
    ``__context__`` chain is not walked: a bug raised while handling a
    retryable error stays FATAL. A ``NativeBuildError`` anywhere ends the
    walk as FATAL."""
    seen = 0
    cur: BaseException | None = exc
    while cur is not None and seen < 5:
        if type(cur).__name__ in _FATAL_TYPE_NAMES:
            return FATAL
        kind = _classify_one(cur)
        if kind != FATAL:
            return kind
        cur = cur.__cause__
        seen += 1
    return FATAL


def is_retryable(kind: str) -> bool:
    """True for kinds :func:`~raft_tpu_torch.resilience.retry.with_retries`
    may re-invoke verbatim."""
    return kind in RETRYABLE
