"""Serving layer: paged mutable IVF storage (counterpart of
``raft_tpu/serving``).

A :class:`PagedListStore` gives ivf_flat / ivf_pq / ivf_bq indexes a
mutable layout — fixed-size pages per list, appended on
:meth:`~PagedListStore.upsert`, tombstoned on
:meth:`~PagedListStore.delete`, scanned in place by the paged kernels (K3
for flat and PQ, K4 for BQ), folded back to a packed index by
:meth:`~PagedListStore.compact`.

Usage::

    from raft_tpu_torch import serving
    from raft_tpu_torch.neighbors import ivf_flat

    index = ivf_flat.build(dataset, ivf_flat.IvfFlatParams(n_lists=1024))
    store = serving.PagedListStore.from_index(index)
    store.reserve(100_000)                      # grow capacity up front
    store.upsert(new_vectors, new_ids)          # appends to tail pages
    store.delete(stale_ids)                     # tombstones in place
    vals, ids = serving.search(store, queries, k=10, n_probes=32)
    store.set_filter(allowed_mask)              # a standing predicate
    vals, ids = serving.search(store, queries, k=10, n_probes=32)
    snapshot = store.compact()                  # packed index, savable

``backend="auto"`` runs K3 / K4 wherever the store's plan can feed k and
the gather scan over the page table otherwise (flat and PQ stores; k >
512, pages under 8 rows). Dynamic batching (``QueryQueue``), the
compaction, maintenance and capacity managers and the burn-rate controller
come with later slices of the port.
"""

from raft_tpu_torch.neighbors import ivf_bq as _ivf_bq
from raft_tpu_torch.neighbors import ivf_flat as _ivf_flat
from raft_tpu_torch.neighbors import ivf_pq as _ivf_pq
from raft_tpu_torch.serving.store import (
    PAGE_ROWS_ENV,
    PagedListStore,
    default_page_rows,
)

_FAMILY = {"ivf_flat": _ivf_flat, "ivf_pq": _ivf_pq, "ivf_bq": _ivf_bq}


def search(store: PagedListStore, queries, k: int, n_probes: int = 20,
           **kwargs):
    """Search a paged store through its kind's paged path
    (``ivf_flat.search_paged`` / ``ivf_pq.search_paged`` /
    ``ivf_bq.search_paged``)."""
    return _FAMILY[store.kind].search_paged(store, queries, k,
                                            n_probes=n_probes, **kwargs)


def paged_engine(store: PagedListStore, k: int) -> str:
    """The engine ``backend="auto"`` resolves to for this store and k."""
    return _ivf_flat.paged_backend_auto(store, k)


def searcher(store: PagedListStore, k: int, n_probes: int = 20, **kwargs):
    """A search function of the queries alone, closed over one store and
    one search configuration."""

    def run(queries):
        return search(store, queries, k, n_probes=n_probes, **kwargs)

    return run


__all__ = [
    "PAGE_ROWS_ENV",
    "PagedListStore",
    "default_page_rows",
    "paged_engine",
    "search",
    "searcher",
]
