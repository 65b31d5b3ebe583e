"""Runtime telemetry (counterpart of ``raft_tpu/obs``): metrics registry,
span trees, device-health probe.

A process-wide registry (obs/registry.py) that hot paths feed counters and
wall-clock spans into behind one ``obs.enabled()`` branch; span trees
(obs/tracing.py) exportable as Chrome trace JSON for Perfetto; and a
subprocess-bounded probe of the card (obs/health.py).

Usage::

    from raft_tpu_torch import obs

    obs.enable()                      # or RAFT_TPU_OBS=1 in the env
    with obs.record_span("my::phase", attrs={"rows": n}):
        with obs.record_span("my::tile"):   # parented under my::phase
            ...
    obs.add("my.rows", n)             # counter
    obs.observe("my.batch_s", dt)     # pow2 histogram (p50/p90/p99 bounds)
    obs.snapshot()                    # {"counters": .., "timers": .., ..}
    obs.export_jsonl("results/obs.jsonl", {"run": "r06"})
    obs.export_chrome_trace("results/trace.json")   # open in Perfetto

Instrumented code gates every emission::

    if obs.enabled():
        obs.add("ivf_pq.search.queries", q)

so the telemetry-off cost of a site is one call and one branch.
``RAFT_TPU_OBS_SYNC=1`` (or :func:`enable_sync`) drains the cards at each
span's exit, so spans report committed time, with the enqueue wall clock
kept as the ``dispatch_s`` attribute.
"""

from raft_tpu_torch.obs import tracing
from raft_tpu_torch.obs.registry import (
    NOOP_SPAN,
    MetricsRegistry,
    add,
    disable,
    enable,
    enabled,
    export_jsonl,
    inc_gauge,
    observe,
    record_span,
    record_timing,
    registry,
    reset,
    set_gauge,
    snapshot,
)
from raft_tpu_torch.obs.tracing import (
    chrome_trace,
    clear_spans,
    disable_sync,
    enable_sync,
    export_chrome_trace,
    process_info,
    spans,
    sync_enabled,
)
from raft_tpu_torch.obs.health import MAX_TIMEOUT, HealthReport, probe

__all__ = [
    "MAX_TIMEOUT",
    "HealthReport",
    "MetricsRegistry",
    "NOOP_SPAN",
    "add",
    "chrome_trace",
    "clear_spans",
    "disable",
    "disable_sync",
    "enable",
    "enable_sync",
    "enabled",
    "export_chrome_trace",
    "export_jsonl",
    "inc_gauge",
    "observe",
    "probe",
    "process_info",
    "record_span",
    "record_timing",
    "registry",
    "reset",
    "set_gauge",
    "snapshot",
    "spans",
    "sync_enabled",
    "tracing",
]
