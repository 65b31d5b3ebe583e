"""Fault tolerance (counterpart of ``raft_tpu/resilience``): classify the
failure, shrink the work, retry.

* :mod:`~raft_tpu_torch.resilience.errors` — :func:`classify` maps raw
  exceptions (CUDA's and the kernel builds' included) to
  ``OOM | TRANSIENT | DEADLINE | FATAL``.
* :mod:`~raft_tpu_torch.resilience.retry` — :func:`with_retries` and
  :func:`degrade_on_oom`, feeding ``resilience.*`` counters and the
  :func:`recent_events` ring.
* :mod:`~raft_tpu_torch.resilience.deadline` — :class:`Deadline` scopes
  that every ``check_interrupt()`` site consults.
* :mod:`~raft_tpu_torch.resilience.faultinject` — :func:`faultpoint` sites
  armed by ``RAFT_TPU_FAULTS=site=oom:1``-style specs.
* :mod:`~raft_tpu_torch.resilience.shard_health` — per-shard health and
  the minimum-coverage quorum.

The hooks wrap the kernel calls and never replace them: no hook catches a
kernel's build or launch failure and carries on without the kernel, and
:func:`degrade_on_oom` re-runs the same path at a smaller size, only for
an OOM-classified error.
"""

from raft_tpu_torch.resilience.deadline import (
    Deadline,
    DeadlineExceeded,
    active_deadline,
    check_deadline,
)
from raft_tpu_torch.resilience.errors import (
    DEADLINE,
    FATAL,
    KINDS,
    OOM,
    TRANSIENT,
    classify,
    is_retryable,
)
from raft_tpu_torch.resilience.faultinject import (
    FaultInjected,
    arm_faults,
    armed_sites,
    clear_faults,
    faultpoint,
)
from raft_tpu_torch.resilience.shard_health import (
    HEALTHY,
    LOST,
    SUSPECT,
    ShardHealth,
    ShardQuorumError,
    reset_shard_health,
    shard_health,
)
from raft_tpu_torch.resilience.retry import (
    RetryPolicy,
    backoff_delays,
    clear_events,
    degrade_on_oom,
    disable_sync,
    enable_sync,
    force_completion,
    recent_events,
    record_event,
    sync_mode,
    with_retries,
)

__all__ = [
    "DEADLINE",
    "Deadline",
    "DeadlineExceeded",
    "FATAL",
    "FaultInjected",
    "HEALTHY",
    "KINDS",
    "LOST",
    "OOM",
    "RetryPolicy",
    "SUSPECT",
    "ShardHealth",
    "ShardQuorumError",
    "TRANSIENT",
    "active_deadline",
    "arm_faults",
    "armed_sites",
    "backoff_delays",
    "check_deadline",
    "classify",
    "clear_events",
    "clear_faults",
    "degrade_on_oom",
    "disable_sync",
    "enable_sync",
    "faultpoint",
    "force_completion",
    "is_retryable",
    "recent_events",
    "record_event",
    "reset_shard_health",
    "shard_health",
    "sync_mode",
    "with_retries",
]
