"""Serving layer (counterpart of ``raft_tpu/serving``): paged mutable IVF
storage, SLO-aware dynamic batching, and the managers that keep a live
store healthy.

A :class:`PagedListStore` gives ivf_flat / ivf_pq / ivf_bq indexes a
mutable layout — fixed-size pages per list, appended on
:meth:`~PagedListStore.upsert`, tombstoned on
:meth:`~PagedListStore.delete`, scanned in place by the paged kernels (K3
for flat and PQ, K4 for BQ), folded back to a packed index by
:meth:`~PagedListStore.compact`. Around it:

* :class:`QueryQueue` coalesces one-at-a-time requests with per-request
  deadlines into batches of a power-of-two bucket ladder under a latency
  SLO, with pre-dispatch admission from ``obs.costmodel``;
* :class:`CompactionManager` reclaims tombstones off the hot path when the
  tombstone ratio crosses ``RAFT_TPU_SERVING_COMPACT_RATIO``;
* :class:`MaintenanceManager` detects drift (fill skew, tombstones, the
  shadow sampler's recall trend) and re-clusters hot lists online,
  swapping a staged clone in with :meth:`~PagedListStore.recluster_swap`;
* :class:`CapacityController` serves many tenants over one memory budget
  with HOT / WARM / COLD tiers (the warm tier is an IVF-BQ twin, K2);
* :class:`BurnRateController` keeps a live queue at its tuned operating
  point (``tuning.autotune``): it reads an SLO engine's burn rates each
  tick and moves one :class:`KnobActuator` (``n_probes``, the queue's batch
  cap, a tenant tier) a rung down under pressure and back when cool.

Usage::

    from raft_tpu_torch import serving
    from raft_tpu_torch.neighbors import ivf_flat

    index = ivf_flat.build(dataset, ivf_flat.IvfFlatParams(n_lists=1024))
    store = serving.PagedListStore.from_index(index)
    store.reserve(100_000)                      # grow capacity up front
    store.upsert(new_vectors, new_ids)          # appends to tail pages
    store.delete(stale_ids)                     # tombstones in place
    vals, ids = serving.search(store, queries, k=10, n_probes=32)

    queue = serving.QueryQueue(serving.searcher(store, k=10, n_probes=32),
                               slo_s=0.05)
    queue.start()                               # or queue.pump() in a loop
    handle = queue.submit(one_query, timeout_s=0.2)
    vals, ids = handle.result()
    serving.CompactionManager(store).pump()     # compact past the ratio

``backend="auto"`` runs K3 / K4 wherever the store's plan can feed k and
the gather scan over the page table otherwise (flat and PQ stores; k >
512, pages under 8 rows).
"""

from raft_tpu_torch import obs
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.neighbors import _packing
from raft_tpu_torch.neighbors import ivf_bq as _ivf_bq
from raft_tpu_torch.neighbors import ivf_flat as _ivf_flat
from raft_tpu_torch.neighbors import ivf_pq as _ivf_pq
from raft_tpu_torch.serving.batching import QueryQueue, RequestHandle
from raft_tpu_torch.serving.capacity import (
    COLD,
    HOT,
    MAX_DEMOTIONS_ENV,
    PROMOTE_DEADLINE_ENV,
    WARM,
    WINDOW_ENV,
    CapacityController,
    CapacityRejected,
    TenantRegistry,
    TenantResult,
)
from raft_tpu_torch.serving.controller import (
    CONTROL_INTERVAL_ENV,
    COOL_WINDOWS_ENV,
    MAX_ACTIONS_ENV,
    BurnRateController,
    KnobActuator,
    default_control_interval,
    default_cool_windows,
    default_max_actions,
)
from raft_tpu_torch.serving.compaction import (
    COMPACT_DEADLINE_ENV,
    COMPACT_INTERVAL_ENV,
    COMPACT_RATIO_ENV,
    CompactionManager,
    default_compact_deadline,
    default_compact_ratio,
)
from raft_tpu_torch.serving.maintenance import (
    MAINT_DEADLINE_ENV,
    MAINT_DRIFT_ENV,
    MAINT_INTERVAL_ENV,
    MAINT_PAIRS_ENV,
    MAINT_SKEW_ENV,
    MaintenanceManager,
    default_drift_threshold,
    default_maintenance_deadline,
    default_maintenance_interval,
    default_max_pairs,
    default_split_skew,
)
from raft_tpu_torch.serving.store import (
    PAGE_ROWS_ENV,
    PagedListStore,
    default_page_rows,
)

_FAMILY = {"ivf_flat": _ivf_flat, "ivf_pq": _ivf_pq, "ivf_bq": _ivf_bq}


@traced("serving::search")
def search(store: PagedListStore, queries, k: int, n_probes: int = 20,
           **kwargs):
    """Search a paged store through its kind's paged path
    (``ivf_flat.search_paged`` / ``ivf_pq.search_paged`` /
    ``ivf_bq.search_paged``)."""
    if obs.enabled():
        obs.add("serving.searches")
    return _FAMILY[store.kind].search_paged(store, queries, k,
                                            n_probes=n_probes, **kwargs)


def paged_engine(store: PagedListStore, k: int) -> str:
    """The engine ``backend="auto"`` resolves to for this store and k."""
    return _ivf_flat.paged_backend_auto(store, k)


def searcher(store: PagedListStore, k: int, n_probes: int = 20, **kwargs):
    """A search function of the queries alone, closed over one store and
    one search configuration — the :class:`QueryQueue`'s ``search_fn``."""

    def run(queries):
        return search(store, queries, k, n_probes=n_probes, **kwargs)

    return run


def scan_trace_count() -> int:
    """New operand signatures the paged scans have met in this process
    (the compile ledger, ``obs/compile.py``): a serving window that
    changes no scan shape holds the delta at 0, and a nonzero delta's
    ledger records name the operand that changed."""
    return _packing.paged_trace_count()


__all__ = [
    "BurnRateController",
    "COLD",
    "COMPACT_DEADLINE_ENV",
    "COMPACT_INTERVAL_ENV",
    "COMPACT_RATIO_ENV",
    "CONTROL_INTERVAL_ENV",
    "COOL_WINDOWS_ENV",
    "CapacityController",
    "CapacityRejected",
    "CompactionManager",
    "HOT",
    "KnobActuator",
    "MAX_ACTIONS_ENV",
    "MAINT_DEADLINE_ENV",
    "MAINT_DRIFT_ENV",
    "MAINT_INTERVAL_ENV",
    "MAINT_PAIRS_ENV",
    "MAINT_SKEW_ENV",
    "MAX_DEMOTIONS_ENV",
    "MaintenanceManager",
    "PAGE_ROWS_ENV",
    "PROMOTE_DEADLINE_ENV",
    "PagedListStore",
    "QueryQueue",
    "RequestHandle",
    "TenantRegistry",
    "TenantResult",
    "WARM",
    "WINDOW_ENV",
    "default_compact_deadline",
    "default_compact_ratio",
    "default_control_interval",
    "default_cool_windows",
    "default_drift_threshold",
    "default_max_actions",
    "default_maintenance_deadline",
    "default_maintenance_interval",
    "default_max_pairs",
    "default_page_rows",
    "default_split_skew",
    "paged_engine",
    "scan_trace_count",
    "search",
    "searcher",
]
