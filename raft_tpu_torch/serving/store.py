"""Paged mutable IVF storage: fixed-size pages, append-only growth
(counterpart of ``raft_tpu/serving/store.py``).

Each IVF list owns a chain of fixed-size pages listed in a page table.
An upsert appends to its list's tail page (a fresh page from the free
list when the tail is full); a delete tombstones the row in place
(``page_ids`` -1, ``page_bias`` +inf). Every device pool — payload pages
``(capacity_pages, page_rows, ·)``, ids, aux, the scan bias and the
kind's second pool — and the ``(n_lists, table_width)`` table has a shape
set by capacity, not by fill, so a serving window pre-sized with
:meth:`PagedListStore.reserve` mutates without growing
(:attr:`~PagedListStore.growth_events` stays put).

Three payloads, one mechanism:

* ``"ivf_flat"`` — raw vectors in the index's dtype; aux and bias are the
  squared L2 norm (0 for inner-product metrics).
* ``"ivf_pq"`` — packed PQ codes of the index's frozen quantizers; aux is
  the list-side LUT half ``b_sum`` and ``page_cache`` holds the int8
  decoded residual rows kernel K3 scans.
* ``"ivf_bq"`` — packed 1-bit (or 2–4-bit) codes; aux and bias are the
  estimator's additive term and ``page_scale`` its per-row factor, which
  kernel K4 reads beside the codes.

Per-row encodes reuse the packed builds' math, so a store holding exactly
an index's rows scans like that index, and :meth:`~PagedListStore.compact`
folds the live rows back into a packed index (serializable through its
``save``).

The pools are replaced, not written in place: a mutation builds new
tensors and swaps them in under the lock, so a search that took its
snapshot (:meth:`~PagedListStore.paged_scan_state`) reads one consistent
state while mutations proceed — the JAX package's immutable-array
contract, at the cost of one pool copy per mutation.

Telemetry, fault injection and recovery are the JAX package's:
``serving::upsert`` / ``serving::delete`` / ``serving::compact`` spans,
``serving.store.*`` counters (upserts, replaced, deletes, compactions,
compact_swaps, set_filter, capacity and table growth, stale and regrown
swaps), and the ``serving.store.upsert`` faultpoint before each appended
chunk. An upsert whose append fails with an OOM-classified error appends
the rest in half-size chunks, down to a page
(``resilience.degrade_on_oom``); chunks already landed stay landed. The
cost layer's hooks are the JAX package's too: ``serving.scatter`` and
``serving.tombstone`` compile-ledger entries (a pool growth is recorded
with the operand that grew) and the ``serving.scatter`` roofline note.
:meth:`~PagedListStore.recluster_swap` adopts a maintenance clone and
:meth:`~PagedListStore.restore_shape` pre-grows to a captured page plan.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.neighbors import ivf_bq as ivf_bq_mod
from raft_tpu_torch.neighbors import ivf_flat as ivf_flat_mod
from raft_tpu_torch.neighbors import ivf_pq as ivf_pq_mod
from raft_tpu_torch.neighbors._packing import pack_lists
from raft_tpu_torch.obs import compile as obs_compile
from raft_tpu_torch.obs import roofline as obs_roofline
from raft_tpu_torch.obs.costmodel import dtype_name
from raft_tpu_torch.ops import linalg
from raft_tpu_torch.ops.distance import sqnorm
from raft_tpu_torch.resilience import degrade_on_oom, faultpoint, record_event

PAGE_ROWS_ENV = "RAFT_TPU_SERVING_PAGE_ROWS"
_DEFAULT_PAGE_ROWS = 128


def default_page_rows() -> int:
    """Page height: ``RAFT_TPU_SERVING_PAGE_ROWS``, default 128 (a
    near-empty list wastes one page; a page fills one 128-column tile of
    the paged kernels)."""
    return max(8, int(os.environ.get(PAGE_ROWS_ENV, _DEFAULT_PAGE_ROWS)))


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, int(v - 1).bit_length())


def _put(pool: torch.Tensor, pp: torch.Tensor, rr: torch.Tensor,
         values) -> torch.Tensor:
    """A copy of ``pool`` with ``values`` written at slots (pp, rr)."""
    return pool.index_put((pp, rr), torch.as_tensor(
        values, dtype=pool.dtype, device=pool.device))


class PagedListStore:
    """Mutable paged IVF storage over a frozen coarse quantizer.

    Made from a built packed index (:meth:`from_index`), whose centers —
    and for PQ / BQ rotation and codebooks — become the frozen quantizers.
    Rows stream in through :meth:`upsert` and out through :meth:`delete`;
    ``serving.search`` scans the pages; :meth:`compact` folds back to the
    packed layout.

    Thread safety: mutations and snapshots take ``_lock``; a search reads
    the tensors of its snapshot, which no mutation writes.
    """

    def __init__(self, kind: str, centers, metric: str, *,
                 page_rows: Optional[int] = None,
                 payload_width: int, payload_dtype,
                 rotation=None, codebooks=None, pq_bits: int = 8,
                 pq_dim: int = 0, codebook_kind: str = "subspace",
                 bq_bits: int = 1, rotation_kind: str = "dense",
                 initial_pages: int = 0,
                 res: Optional[Resources] = None,
                 device: Optional[DeviceLike] = None):
        if kind not in ("ivf_flat", "ivf_pq", "ivf_bq"):
            raise ValueError(f"unknown store kind {kind!r}")
        if kind == "ivf_pq" and codebook_kind != "subspace":
            raise ValueError("paged ivf_pq serving supports "
                             "codebook_kind='subspace' only")
        if kind == "ivf_bq" and rotation is None:
            raise ValueError("ivf_bq stores need the index rotation")
        self._res = resources_for(device, res)
        dev = self._res.device
        self.kind = kind
        self.metric = metric
        self.centers = torch.as_tensor(centers).to(dev)
        self.rotation = None if rotation is None else \
            torch.as_tensor(rotation).to(dev)
        self.codebooks = None if codebooks is None else \
            torch.as_tensor(codebooks).to(dev)
        self.pq_bits = int(pq_bits)
        self.pq_dim = int(pq_dim)
        self.codebook_kind = codebook_kind
        self.bq_bits = int(bq_bits)
        self.rotation_kind = rotation_kind
        self.page_rows = int(page_rows or default_page_rows())
        self._lock = threading.RLock()

        n_lists = int(self.centers.shape[0])
        cap = max(8, _pow2_at_least(initial_pages or n_lists))
        R = self.page_rows
        # Device pools are replaced whole under _lock, never written in
        # place; off-lock reads (dtype/shape probes, snapshot references)
        # see a consistent old-or-new tensor — hence reads-ok. The host
        # tables below them are mutated in place and carry no reads-ok:
        # every read holds the lock (or comes through a locked snapshot).
        self.pages = torch.zeros((cap, R, int(payload_width)),
                                 dtype=payload_dtype, device=dev)  # guarded-by: _lock, reads-ok
        self.page_ids = torch.full((cap, R), -1, dtype=torch.int32,
                                   device=dev)  # guarded-by: _lock, reads-ok
        # aux starts at +inf, the packed b_sum's padding value
        self.page_aux = torch.full((cap, R), float("inf"),
                                   device=dev)  # guarded-by: _lock, reads-ok
        # the paged kernels' scan bias: +inf wherever a row is absent/dead
        self.page_bias = torch.full((cap, R), float("inf"),
                                    device=dev)  # guarded-by: _lock, reads-ok
        self.page_cache = None  # guarded-by: _lock, reads-ok
        self.page_scale = None  # guarded-by: _lock, reads-ok
        if kind == "ivf_pq":
            dsub = int(self.codebooks.shape[2])
            self._cache_dim = self.pq_dim * dsub
            self.page_cache = torch.zeros((cap, R, self._cache_dim),
                                          dtype=torch.int8, device=dev)
            # the packed path's data-independent dequant scale
            self.decoded_scale = torch.clamp(self.codebooks.abs().max(),
                                             min=1e-30) / 127.0
        elif kind == "ivf_bq":
            self.page_scale = torch.zeros((cap, R), device=dev)

        self._table = np.full((n_lists, 4), -1, np.int32)  # guarded-by: _lock
        self._list_pages = np.zeros(n_lists, np.int32)  # guarded-by: _lock -- chain length
        self._fill = np.zeros(cap, np.int32)  # guarded-by: _lock -- rows ever appended per page
        self._page_list = np.full(cap, -1, np.int32)  # guarded-by: _lock -- owning list, -1 free
        self._free: List[int] = list(range(cap))  # guarded-by: _lock
        self._id_loc: Dict[int, Tuple[int, int]] = {}  # guarded-by: _lock
        self._tombstones = 0  # guarded-by: _lock
        self._list_live = np.zeros(n_lists, np.int64)  # guarded-by: _lock
        self._dev_table = None  # guarded-by: _lock -- device mirror, reset on table change
        self._dev_lens = None   # guarded-by: _lock -- device chain-length mirror
        self._version = 0       # guarded-by: _lock -- bumped on every committed mutation
        self._growths = 0       # guarded-by: _lock
        # the standing predicate (set_filter); not a swap field, so it
        # survives compact_swap (clones are built filterless)
        self.filter = None      # guarded-by: _lock, reads-ok

    # -- construction -------------------------------------------------------
    @classmethod
    def from_index(cls, index, *, page_rows: Optional[int] = None,
                   include_rows: bool = True,
                   res: Optional[Resources] = None,
                   device: Optional[DeviceLike] = None) -> "PagedListStore":
        """Wrap a built packed index: its quantizers become the store's
        frozen quantizers and (by default) its live rows are paged in, in
        packed list order, so the store scans like the index."""
        common = dict(page_rows=page_rows, res=res, device=device)
        if isinstance(index, ivf_flat_mod.IvfFlatIndex):
            store = cls(
                "ivf_flat", index.centers, index.metric,
                payload_width=int(index.list_data.shape[2]),
                payload_dtype=index.list_data.dtype, **common)
        elif isinstance(index, ivf_pq_mod.IvfPqIndex):
            store = cls(
                "ivf_pq", index.centers, index.metric,
                payload_width=int(index.list_codes.shape[2]),
                payload_dtype=index.list_codes.dtype,
                rotation=index.rotation, codebooks=index.codebooks,
                pq_bits=index.pq_bits, pq_dim=index.pq_dim,
                codebook_kind=index.codebook_kind, **common)
        elif isinstance(index, ivf_bq_mod.IvfBqIndex):
            store = cls(
                "ivf_bq", index.centers, index.metric,
                payload_width=int(index.list_codes.shape[2]),
                payload_dtype=index.list_codes.dtype,
                rotation=index.rotation, bq_bits=index.bits,
                rotation_kind=index.rotation_kind, **common)
        else:
            raise TypeError(f"unsupported index type {type(index).__name__}")
        if include_rows:
            store._ingest_packed(index)
        return store

    def _ingest_packed(self, index) -> None:  # holds: _lock
        """Append the packed index's live rows, per list in slot order (the
        arrival order an upsert stream would have given). Payloads, aux,
        bias and the second pool's rows are copied (or derived as the packed
        scan derives them), not recomputed.

        Callers own exclusivity: both call sites (``from_index``,
        ``compact_swap``'s staging clone) fill a store no other thread can
        see yet."""
        dev = self.centers.device
        extra2 = None
        if self.kind == "ivf_flat":
            payload3, ids2 = index.list_data, index.list_ids
            aux2 = index.list_norms
            if aux2 is None:
                aux2 = torch.zeros(ids2.shape, dtype=torch.float32,
                                   device=ids2.device)
            bias2 = aux2  # the ragged scan's bias: norms (L2) / zeros (ip)
        elif self.kind == "ivf_pq":
            payload3, ids2, aux2 = index.list_codes, index.list_ids, index.b_sum
            if self.metric in ("sqeuclidean", "euclidean"):
                rc2 = ivf_pq_mod._center_rot_sqnorm(
                    index.centers, index.rotation)
                bias2 = rc2[:, None] + aux2
            else:
                bias2 = aux2
            if index.decoded is None:
                index.decoded, index.decoded_scale = ivf_pq_mod._decode_lists(
                    index.codebooks, index.list_codes, index.pq_dim,
                    index.pq_bits)
            extra2 = index.decoded
        else:  # ivf_bq: aux carries the additive term, extra the scale
            payload3, ids2 = index.list_codes, index.list_ids
            aux2 = torch.where(index.list_ids >= 0, index.list_bias, 0.0)
            bias2 = index.list_bias
            extra2 = index.list_scale
        ids_np = ids2.cpu().numpy()
        n_lists, max_size = ids_np.shape
        sel_np = np.nonzero(ids_np.reshape(-1) >= 0)[0]
        labels_np = np.repeat(np.arange(n_lists, dtype=np.int32),
                              max_size)[sel_np]
        sel = torch.from_numpy(sel_np).to(ids2.device)

        def rows(t):
            return t.reshape((-1,) + tuple(t.shape[2:]))[sel].to(dev)

        self._append(rows(payload3), ids_np.reshape(-1)[sel_np], rows(aux2),
                     labels_np, rows(bias2),
                     None if extra2 is None else rows(extra2))

    # -- introspection ------------------------------------------------------
    @property
    def n_lists(self) -> int:
        return int(self.centers.shape[0])

    @property
    def dim(self) -> int:
        return int(self.centers.shape[1])

    @property
    def device(self) -> torch.device:
        return self.centers.device

    @property
    def capacity_pages(self) -> int:
        return int(self.pages.shape[0])

    @property
    def size(self) -> int:
        """Live (non-tombstoned) rows."""
        with self._lock:
            return len(self._id_loc)

    @property
    def tombstones(self) -> int:
        with self._lock:
            return self._tombstones

    @property
    def pages_used(self) -> int:
        with self._lock:
            return self.capacity_pages - len(self._free)

    @property
    def table_width(self) -> int:
        with self._lock:
            return int(self._table.shape[1])

    @property
    def growth_events(self) -> int:
        """Capacity growths (page pool or table width) since creation: each
        one changes the scan operands' shapes; steady-state serving inside
        a reserved window holds it fixed."""
        with self._lock:
            return self._growths

    @property
    def mutation_version(self) -> int:
        """Counter bumped on every committed mutation (append, tombstone,
        growth, compaction swap): the token :meth:`compact_swap` validates
        its snapshot against."""
        with self._lock:
            return self._version

    @property
    def tombstone_ratio(self) -> float:
        with self._lock:
            return self._tombstones / max(1, len(self._id_loc))

    def list_fill_counts(self) -> np.ndarray:
        """Live rows per list (a copy of the host counters)."""
        with self._lock:
            return self._list_live.copy()

    def list_skew(self) -> float:
        """``max / mean`` live rows over all lists: 1.0 is balanced, 0.0
        empty."""
        counts = self.list_fill_counts()
        total = int(counts.sum())
        if total <= 0:
            return 0.0
        return float(counts.max() * counts.shape[0] / total)

    def stats(self) -> dict:
        with self._lock:
            used = self.pages_used
            return {
                "kind": self.kind, "rows": self.size,
                "tombstones": self._tombstones, "pages_used": used,
                "capacity_pages": self.capacity_pages,
                "page_rows": self.page_rows,
                "table_width": self.table_width,
                "fill_fraction": self.size / max(1, used * self.page_rows),
                "tombstone_ratio": self.tombstone_ratio,
                "list_skew": round(self.list_skew(), 4),
                "growth_events": self._growths,
                "mutation_version": self._version,
            }

    def set_filter(self, mask) -> None:
        """Install (or clear, with ``None``) the store's standing predicate:
        a :class:`~raft_tpu_torch.core.bitset.Bitset` over source ids, or a
        boolean array made into one on the store's device. Every paged
        search that passes no ``filter`` of its own takes it; ids at or past
        its length fail, so rows upserted after the mask was built are
        excluded. Counts as a mutation (``mutation_version`` moves)."""
        if mask is not None and not isinstance(mask, Bitset):
            mask = Bitset.from_mask(mask, device=self.device)
        with self._lock:
            self.filter = mask
            self._version += 1
        if obs.enabled():
            obs.add("serving.store.set_filter")

    def device_table(self) -> torch.Tensor:
        """Device mirror of the page table, rebuilt only after the table
        changed."""
        with self._lock:
            if self._dev_table is None:
                self._dev_table = torch.from_numpy(self._table.copy()).to(
                    self.device)
            return self._dev_table

    def scan_state(self):
        """One consistent ``(pages, page_ids, page_aux, table)`` snapshot."""
        with self._lock:
            return self.pages, self.page_ids, self.page_aux, \
                self.device_table()

    def paged_scan_state(self):
        """One consistent snapshot for the paged kernels: ``(payload_pool,
        bias_pool, scale_pool_or_None, page_ids, table, chain_pages)``. The
        payload pool is the page pool for flat/bq and the int8 decoded
        cache for pq; ``chain_pages`` is the device mirror of each list's
        live page count."""
        with self._lock:
            if self._dev_lens is None:
                self._dev_lens = torch.from_numpy(self._list_pages.copy()).to(
                    self.device)
            payload = self.page_cache if self.kind == "ivf_pq" else self.pages
            return (payload, self.page_bias, self.page_scale, self.page_ids,
                    self.device_table(), self._dev_lens)

    # -- capacity -----------------------------------------------------------
    def _grow_pages(self, min_pages: int) -> None:
        old = self.capacity_pages
        new = old
        while new < min_pages:
            new *= 2
        if new == old:
            return
        pad = new - old

        def grown(pool, fill):
            return torch.cat([pool, torch.full(
                (pad,) + tuple(pool.shape[1:]), fill, dtype=pool.dtype,
                device=pool.device)])

        self.pages = grown(self.pages, 0)
        self.page_ids = grown(self.page_ids, -1)
        self.page_aux = grown(self.page_aux, float("inf"))
        self.page_bias = grown(self.page_bias, float("inf"))
        if self.page_cache is not None:
            self.page_cache = grown(self.page_cache, 0)
        if self.page_scale is not None:
            self.page_scale = grown(self.page_scale, 0.0)
        self._fill = np.concatenate([self._fill, np.zeros(pad, np.int32)])
        self._page_list = np.concatenate(
            [self._page_list, np.full(pad, -1, np.int32)])
        self._free.extend(range(old, new))
        self._growths += 1
        self._version += 1
        obs.add("serving.store.capacity_growth")
        record_event("serving_capacity_growth", pages_from=old, pages_to=new)

    def _grow_table(self, min_width: int) -> None:
        old_w = self.table_width
        new_w = _pow2_at_least(max(min_width, old_w + 1))
        grown = np.full((self.n_lists, new_w), -1, np.int32)
        grown[:, :old_w] = self._table
        self._table = grown
        self._dev_table = None
        self._growths += 1
        self._version += 1
        obs.add("serving.store.table_growth")

    def reserve(self, n_rows: int, skew_factor: int = 4) -> None:
        """Pre-size capacity for ``n_rows`` more rows, so a serving window
        of known load grows up front, not mid-traffic: the page pool for
        the worst case (every list's tail page full) and the table width
        for a ``skew_factor``×-mean per-list load, or the longest chain
        plus this reservation's share, whichever is wider."""
        with self._lock:
            need = -(-int(n_rows) // self.page_rows) + self.n_lists
            self._grow_pages(self.pages_used + need)
            total = self.size + int(n_rows)
            mean_rows = -(-total // self.n_lists)
            per_list = -(-mean_rows * skew_factor // self.page_rows) + 1
            longest = int(self._list_pages.max()) if self.n_lists else 0
            per_list = max(per_list,
                           longest + -(-int(n_rows) //
                                       (self.n_lists * self.page_rows)) + 1)
            if per_list > self.table_width:
                self._grow_table(per_list)

    # -- allocation (host) --------------------------------------------------
    def _alloc_slots(self, labels_np: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """A (page, row) slot for each new row: the list's tail page while
        it has room, then fresh pages from the free list. Rows are grouped
        by label with one stable sort, so batch order within a list is
        kept and each group is carved into contiguous page runs."""
        labels_np = np.asarray(labels_np)
        n = labels_np.shape[0]
        pp = np.empty(n, np.int64)
        rr = np.empty(n, np.int64)
        order = np.argsort(labels_np, kind="stable")
        uniq, starts = np.unique(labels_np[order], return_index=True)
        bounds = np.append(starts[1:], n)
        page_rows = self.page_rows
        for lab, s, e in zip(uniq.tolist(), starts.tolist(), bounds.tolist()):
            idxs = order[s:e]
            cnt = e - s
            pos = 0
            while pos < cnt:
                count = int(self._list_pages[lab])
                tail = int(self._table[lab, count - 1]) if count else -1
                if tail < 0 or self._fill[tail] >= page_rows:
                    if not self._free:
                        self._grow_pages(self.capacity_pages + 1)
                    tail = self._free.pop()
                    if count >= self.table_width:
                        self._grow_table(count + 1)
                    self._table[lab, count] = tail
                    self._list_pages[lab] = count + 1
                    self._page_list[tail] = lab
                    self._dev_table = None
                    self._dev_lens = None
                take = min(cnt - pos, page_rows - int(self._fill[tail]))
                sel = idxs[pos:pos + take]
                pp[sel] = tail
                rr[sel] = int(self._fill[tail]) + np.arange(take)
                self._fill[tail] += take
                pos += take
        return pp, rr

    # -- mutation -----------------------------------------------------------
    def _assign_labels(self, work: torch.Tensor) -> np.ndarray:
        km_metric = ("inner_product"
                     if self.metric in ("cosine", "inner_product")
                     else "sqeuclidean")
        labels = kmeans_balanced.predict(
            work, self.centers,
            kmeans_balanced.KMeansBalancedParams(metric=km_metric),
            res=self._res)
        return labels.cpu().numpy()

    def _prepare_payload(self, work: torch.Tensor, labels_np: np.ndarray):
        """(payload, aux, bias, extra) rows for the pools, by the packed
        builds' math. ``bias`` is the scan-bias row, ``extra`` the second
        pool's row (PQ decoded cache / BQ scale) or None."""
        l2 = self.metric in ("sqeuclidean", "euclidean")
        labels = torch.from_numpy(np.asarray(labels_np, np.int64)).to(
            self.device)
        if self.kind == "ivf_flat":
            dt = self.pages.dtype
            if not dt.is_floating_point:
                info = torch.iinfo(dt)
                # half-to-even rounding, then clip: jnp.round's rule
                payload = torch.clamp(torch.round(work), info.min,
                                      info.max).to(dt)
            else:
                payload = work.to(dt)
            aux = sqnorm(payload) if l2 else torch.zeros(
                work.shape[0], device=work.device)
            return payload, aux, aux, None
        if self.kind == "ivf_bq":
            rc = linalg.rotate_rows(self.centers, self.rotation,
                                    self.rotation_kind)
            c2 = sqnorm(self.centers)
            payload, scale, bias = ivf_bq_mod._encode_chunk(
                work, labels, self.centers, self.rotation, rc, c2, l2,
                self.bq_bits, self.rotation_kind)
            return payload, bias, bias, scale
        dsub = self.codebooks.shape[2]
        resid = linalg.rotate_rows(work - self.centers[labels], self.rotation)
        codes = ivf_pq_mod._encode(resid.reshape(work.shape[0], self.pq_dim,
                                                 dsub), self.codebooks)
        payload = ivf_pq_mod.pack_codes(codes, self.pq_bits)
        if l2:
            aux = ivf_pq_mod._row_b_sum(
                self.centers, self.rotation, self.codebooks, payload, labels,
                self.pq_dim, self.pq_bits)
            rc2 = ivf_pq_mod._center_rot_sqnorm(self.centers, self.rotation)
            bias = rc2[labels] + aux
        else:
            aux = torch.zeros(work.shape[0], device=work.device)
            bias = aux
        extra = ivf_pq_mod._decode_code_rows(
            self.codebooks, payload, self.decoded_scale, self.pq_dim,
            self.pq_bits)
        return payload, aux, bias, extra

    @traced("serving::upsert")
    def upsert(self, vectors, ids=None) -> dict:
        """Insert rows, or replace them by id: each goes to its nearest
        center's list, appended to the tail page. Pool and table shapes
        change only when capacity itself grows. An OOM-classified failure
        of the append retries the rest at half the chunk, down to a page.

        Returns ``{"upserts": n, "replaced": r, "growths": g}``."""
        if isinstance(vectors, np.ndarray):
            vectors = np.ascontiguousarray(vectors)
        vectors = torch.as_tensor(vectors).to(self.device)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(
                f"vectors must be (n, {self.dim}), got {tuple(vectors.shape)}")
        n = int(vectors.shape[0])
        if n == 0:
            return {"upserts": 0, "replaced": 0, "growths": 0}
        work = vectors.to(torch.float32)
        if self.metric == "cosine":
            work = work / torch.clamp(torch.linalg.vector_norm(
                work, dim=1, keepdim=True), min=1e-30)
        if ids is not None:
            ids_np = np.asarray(torch.as_tensor(ids).cpu(), np.int64)
            if ids_np.shape != (n,):
                raise ValueError(f"ids must be ({n},), got {ids_np.shape}")
            if len(set(ids_np.tolist())) != n:
                raise ValueError("duplicate ids within one upsert batch")
            if ids_np.min() < 0 or ids_np.max() >= 2**31 - 1:
                raise ValueError("ids must fit int32 and be >= 0")

        labels_np = self._assign_labels(work)
        payload, aux, bias, extra = self._prepare_payload(work, labels_np)

        with self._lock:
            if ids is None:
                # auto ids inside the lock: two concurrent batches must not
                # mint the same ids
                start = (max(self._id_loc) + 1) if self._id_loc else 0
                ids_np = np.arange(start, start + n, dtype=np.int64)
                if ids_np.max() >= 2**31 - 1:
                    raise ValueError("ids must fit int32 and be >= 0")
            # replaced ids: capture the old slots now, tombstone them only
            # after the append lands, so a failed append loses nothing
            old_locs = [self._id_loc[int(i)] for i in ids_np
                        if int(i) in self._id_loc]
            g0 = self._growths
            done = [0]  # survives degraded retries: landed chunks stay

            def append_chunks(chunk_rows: int):
                while done[0] < n:
                    faultpoint("serving.store.upsert")
                    s, e = done[0], min(n, done[0] + chunk_rows)
                    self._append(payload[s:e], ids_np[s:e], aux[s:e],
                                 labels_np[s:e], bias[s:e],
                                 None if extra is None else extra[s:e])
                    done[0] = e
                return n

            degrade_on_oom(append_chunks, n, floor=min(n, self.page_rows),
                           site="serving.store.upsert")
            if old_locs:
                self._tombstone_slots(old_locs)
            growths = self._growths - g0
        if obs.enabled():
            obs.add("serving.store.upserts", n)
            if old_locs:
                obs.add("serving.store.replaced", len(old_locs))
            # the append is pure data movement (flops 0, memory-bound by
            # construction); the model prices the rows and the kind's
            # second pool row (int8 cache for PQ, fp32 scale for BQ)
            extra_bytes = 0
            if self.kind == "ivf_pq":
                extra_bytes = self._cache_dim
            elif self.kind == "ivf_bq":
                extra_bytes = 4
            obs_roofline.note_dispatch(
                "serving.scatter",
                {"n_rows": n, "dim": self.dim,
                 "payload_width": int(self.pages.shape[2]),
                 "payload_dtype": dtype_name(self.pages.dtype),
                 "extra_row_bytes": extra_bytes})
        return {"upserts": n, "replaced": len(old_locs), "growths": growths}

    def _append(self, payload, ids_np, aux, labels_np, bias, extra) -> None:
        """Allocate slots and write one batch (lock held): device state
        first, the host id map after, so a raise leaves the store as it was
        (slots burned in ``_fill`` count as padding)."""
        m = int(payload.shape[0])
        if m == 0:
            return
        ids_np = np.asarray(ids_np, np.int64)
        pp_np, rr_np = self._alloc_slots(np.asarray(labels_np))
        pp = torch.from_numpy(pp_np).to(self.device)
        rr = torch.from_numpy(rr_np).to(self.device)
        # a capacity growth lands in the ledger attributed to the pool
        # operand that grew (obs/compile.py)
        obs_compile.trace_event(
            "serving.scatter", pages=self.pages, page_ids=self.page_ids,
            page_aux=self.page_aux, page_bias=self.page_bias,
            extra_pool=(self.page_cache if self.kind == "ivf_pq"
                        else self.page_scale),
            payload=payload, ids=ids_np, aux=aux, pp=pp, rr=rr)
        pages = _put(self.pages, pp, rr, payload)
        page_ids = _put(self.page_ids, pp, rr,
                        torch.from_numpy(ids_np.astype(np.int32)))
        page_aux = _put(self.page_aux, pp, rr, aux)
        page_bias = _put(self.page_bias, pp, rr, bias)
        if self.kind == "ivf_pq":
            self.page_cache = _put(self.page_cache, pp, rr, extra)
        elif self.kind == "ivf_bq":
            self.page_scale = _put(self.page_scale, pp, rr, extra)
        self.pages, self.page_ids, self.page_aux = pages, page_ids, page_aux
        self.page_bias = page_bias
        for i in range(m):
            self._id_loc[int(ids_np[i])] = (int(pp_np[i]), int(rr_np[i]))
        np.add.at(self._list_live, np.asarray(labels_np, np.int64)[:m], 1)
        self._version += 1

    def _tombstone_slots(self, locs: List[Tuple[int, int]]) -> None:
        """Mark (page, row) slots dead (lock held): ``page_ids`` -1 and
        ``page_bias`` +inf. Slots are not reused; compact() reclaims them."""
        pp_np = np.array([p for p, _ in locs], np.int64)
        rr_np = np.array([r for _, r in locs], np.int64)
        labs = self._page_list[pp_np]
        np.subtract.at(self._list_live, labs[labs >= 0], 1)
        pp = torch.from_numpy(pp_np).to(self.device)
        rr = torch.from_numpy(rr_np).to(self.device)
        obs_compile.trace_event("serving.tombstone", page_ids=self.page_ids,
                                page_bias=self.page_bias, pp=pp, rr=rr)
        self.page_ids = _put(self.page_ids, pp, rr, -1)
        self.page_bias = _put(self.page_bias, pp, rr, float("inf"))
        self._tombstones += len(locs)
        self._version += 1

    def _tombstone_ids(self, present: List[int]) -> int:
        """Tombstone rows by id and drop them from the id map (lock held)."""
        if not present:
            return 0
        self._tombstone_slots([self._id_loc[i] for i in present])
        for i in present:
            del self._id_loc[i]
        return len(present)

    @traced("serving::delete")
    def delete(self, ids) -> int:
        """Tombstone rows by id; unknown ids are ignored. Returns the
        number of rows removed."""
        ids_np = np.asarray(torch.as_tensor(ids).cpu()).reshape(-1)
        with self._lock:
            removed = self._tombstone_ids(
                [int(i) for i in ids_np if int(i) in self._id_loc])
        if obs.enabled() and removed:
            obs.add("serving.store.deletes", removed)
        return removed

    # -- compaction ---------------------------------------------------------
    def _live_rows(self):
        """(payload, aux, extra, ids, labels) of the live rows in per-list
        chain order (the arrival order, which a from-scratch pack over the
        same rows keeps). Only the snapshot holds the lock; the gathers run
        on its tensors outside it."""
        with self._lock:
            table = self._table.copy()
            list_pages = self._list_pages.copy()
            fill = self._fill.copy()
            page_list = self._page_list.copy()
            pages, page_ids = self.pages, self.page_ids
            page_aux, page_scale = self.page_aux, self.page_scale
        perm = []
        for lab in range(self.n_lists):
            for p in table[lab, :list_pages[lab]]:
                base = int(p) * self.page_rows
                perm.extend(range(base, base + int(fill[p])))
        perm = np.asarray(perm, np.int64)
        ids_flat = page_ids.cpu().numpy().reshape(-1)
        labels_flat = np.repeat(page_list, self.page_rows)
        if perm.size:
            ids_sel = ids_flat[perm]
            live = ids_sel >= 0
            perm = perm[live]
            ids_sel = ids_sel[live]
            labels_sel = labels_flat[perm]
        else:
            ids_sel = np.empty(0, np.int32)
            labels_sel = np.empty(0, np.int32)
        perm_dev = torch.from_numpy(perm).to(self.device)
        payload = pages.reshape((-1,) + tuple(pages.shape[2:]))[perm_dev]
        aux = page_aux.reshape(-1)[perm_dev]
        extra = None if page_scale is None else page_scale.reshape(-1)[perm_dev]
        return (payload, aux, extra, ids_sel.astype(np.int32),
                labels_sel.astype(np.int32))

    @traced("serving::compact")
    def compact(self):
        """Fold the live rows back into the packed representation: an
        ``IvfFlatIndex`` / ``IvfPqIndex`` / ``IvfBqIndex`` over exactly the
        surviving rows with the store's quantizers, lists padded to the
        strip granule (512, power-of-two chunks). The per-row aux (norms,
        b_sum, BQ bias and scale) is carried, not recomputed, so the packed
        scan scores exactly as the paged one did."""
        payload, aux, extra, ids_np, labels_np = self._live_rows()
        group = 512
        ids_dev = torch.from_numpy(ids_np).to(self.device)
        labels_dev = torch.from_numpy(labels_np.astype(np.int64)).to(
            self.device)
        list_payload, list_ids = pack_lists(
            payload, ids_dev, labels_dev, self.n_lists, group,
            pow2_chunks=True)
        if obs.enabled():
            obs.add("serving.store.compactions")
        if self.kind == "ivf_bq":
            aux2, _ = pack_lists(torch.stack([extra, aux], dim=1), ids_dev,
                                 labels_dev, self.n_lists, group,
                                 pow2_chunks=True)
            return ivf_bq_mod.IvfBqIndex(
                self.centers, self.rotation, list_payload, list_ids,
                aux2[:, :, 0].contiguous(),
                torch.where(list_ids >= 0, aux2[:, :, 1],
                            float("inf")).contiguous(),
                self.metric, self.bq_bits, self.rotation_kind)
        aux_packed, _ = pack_lists(aux, ids_dev, labels_dev, self.n_lists,
                                   group, pow2_chunks=True)
        if self.kind == "ivf_flat":
            norms = (aux_packed if self.metric in ("sqeuclidean", "euclidean")
                     else None)
            return ivf_flat_mod.IvfFlatIndex(
                self.centers, list_payload, list_ids, norms, self.metric,
                group)
        # the packed convention: +inf at padding, so the scan self-masks
        b_sum = torch.where(list_ids >= 0, aux_packed, float("inf"))
        return ivf_pq_mod.IvfPqIndex(
            self.centers, self.rotation, self.codebooks, list_payload,
            list_ids, b_sum, self.metric, self.pq_bits, group,
            self.codebook_kind, self.pq_dim)

    def _empty_clone(self, centers=None) -> "PagedListStore":
        """A row-free store with the same quantizers, page height, pool
        capacity and table width: the staging target of a compaction swap
        (same capacity, so the swap changes no operand shape). ``centers``
        (same shape) replaces the coarse centroids."""
        if centers is None:
            centers = self.centers
        else:
            centers = torch.as_tensor(centers).to(self.centers)
            if centers.shape != self.centers.shape:
                raise ValueError(
                    f"replacement centers must be {tuple(self.centers.shape)}, "
                    f"got {tuple(centers.shape)}")
        with self._lock:
            # one consistent (pool, capacity, width) triple
            pages = self.pages
            cap = self.capacity_pages
            width = self.table_width
        clone = PagedListStore(
            self.kind, centers, self.metric, page_rows=self.page_rows,
            payload_width=int(pages.shape[2]), payload_dtype=pages.dtype,
            rotation=self.rotation, codebooks=self.codebooks,
            pq_bits=self.pq_bits, pq_dim=self.pq_dim,
            codebook_kind=self.codebook_kind, bq_bits=self.bq_bits,
            rotation_kind=self.rotation_kind, initial_pages=cap,
            res=self._res)
        if clone.table_width < width:
            clone._table = np.full((self.n_lists, width), -1, np.int32)
        return clone

    _SWAP_FIELDS = ("pages", "page_ids", "page_aux", "page_bias",
                    "page_cache", "page_scale", "_table", "_list_pages",
                    "_fill", "_page_list", "_free", "_id_loc", "_list_live")

    def _adopt_clone(self, clone: "PagedListStore", expected_version: int,
                     tag: str) -> bool:
        """The atomic swap: re-validate ``mutation_version`` against
        ``expected_version`` (a mutation after the caller's snapshot aborts:
        False, nothing changed, counted ``serving.store.<tag>_stale``),
        refuse a clone whose staging grew the operand shapes
        (``<tag>_regrown``), then adopt its pools, host tables and
        centers."""
        with self._lock:
            if self._version != int(expected_version):
                obs.add(f"serving.store.{tag}_stale")
                return False
            if (clone.capacity_pages != self.capacity_pages
                    or clone.table_width != self.table_width):
                obs.add(f"serving.store.{tag}_regrown")
                return False
            for name in self._SWAP_FIELDS:
                setattr(self, name, getattr(clone, name))
            self.centers = clone.centers
            self._tombstones = 0
            self._dev_table = None
            self._dev_lens = None
            self._version += 1
        return True

    def compact_swap(self, compacted, expected_version: int) -> bool:
        """Adopt a compacted index as the store's paged state: live rows
        re-paged front to back (tombstoned slots back on the free list),
        capacity and table width unchanged. The re-page runs on a staging
        clone off the lock; a mutation since ``expected_version`` (the
        :attr:`mutation_version` read before :meth:`compact`) aborts the
        swap and returns False."""
        clone = self._empty_clone()
        clone._ingest_packed(compacted)
        if not self._adopt_clone(clone, expected_version, "compact_swap"):
            return False
        if obs.enabled():
            obs.add("serving.store.compact_swaps")
        return True

    def recluster_swap(self, clone: "PagedListStore",
                       expected_version: int) -> bool:
        """Adopt a maintenance staging clone — same capacity, table width
        and operand shapes, possibly new centers — atomically. The clone
        holds the full surviving row set; a mutation since
        ``expected_version`` aborts (False, nothing changed), as in
        :meth:`compact_swap`."""
        if not self._adopt_clone(clone, expected_version, "recluster_swap"):
            return False
        if obs.enabled():
            obs.add("serving.store.recluster_swaps")
        return True

    def restore_shape(self, capacity_pages: int, table_width: int) -> None:
        """Pre-grow to a captured ``(capacity_pages, table_width)``: the
        page plan the capacity plane keeps across a tier round trip, so a
        promoted store scans at the operand shapes it had before demotion.
        The device table mirror is built here, off the serving path."""
        with self._lock:
            if int(capacity_pages) > self.capacity_pages:
                self._grow_pages(int(capacity_pages))
            if int(table_width) > self.table_width:
                self._grow_table(int(table_width))
            self.device_table()

    def _ingest_rows(self, payload, ids_np, aux, labels_np, bias, extra,
                     chunk_rows: int = 65536) -> None:  # holds: _lock
        """Append pre-encoded rows, in their final per-list order, to an
        unpublished staging clone, in chunks of ``chunk_rows``."""
        n = int(np.asarray(ids_np).shape[0])
        for s in range(0, n, int(chunk_rows)):
            e = min(n, s + int(chunk_rows))
            self._append(payload[s:e], ids_np[s:e], aux[s:e],
                         labels_np[s:e], bias[s:e],
                         None if extra is None else extra[s:e])
