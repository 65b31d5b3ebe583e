"""Profiler trace ranges (counterpart of ``raft_tpu/core/trace.py``).

:func:`trace_range` marks a block: the registry's span with telemetry on,
else a ``torch.profiler.record_function`` range. The :func:`traced`
decorator is the entry-point annotation of the build and search paths:
with telemetry on
(``RAFT_TPU_OBS=1`` / :func:`raft_tpu_torch.obs.enable`) it opens the
registry's span (:func:`raft_tpu_torch.obs.record_span`), which marks the
timeline too and records the duration and one node of the span tree; with
telemetry off it costs one branch.
"""

from __future__ import annotations

import functools

import torch

from raft_tpu_torch import obs as _obs


def trace_range(name: str):
    """A named range::

        with trace_range("ivf_pq::search"):
            ...

    the registry's span when telemetry is on (which marks the profiler
    timeline too), else a ``torch.profiler.record_function`` range alone."""
    if _obs.enabled():
        return _obs.record_span(name)
    return torch.profiler.record_function(name)


def traced(name: str):
    """Decorator wrapping a function body in the registry's span ``name``
    when telemetry is on."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _obs.enabled():
                with _obs.record_span(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)

        return wrapper

    return deco
