"""Multi-tenant capacity plane (counterpart of
``raft_tpu/serving/capacity.py``): acting admission and tiered residency.

``obs.costmodel.check_admission`` gives exact per-index memory prediction
and classified ADMIT / QUEUE / REJECT verdicts; this module makes them
binding, so oversubscription degrades instead of running out of memory:

* :class:`TenantRegistry` — named index/store namespaces, each at a
  **residency tier**:

  ======  ==========================================================
  HOT     full index resident (plus the warm codes); exact serving
  WARM    only the IVF-BQ sign codes resident; serves **degraded**
          (``degraded=True`` on the result); the v2 snapshot on disk is
          the promote source
  COLD    v2 snapshot only — nothing resident; the first query pages the
          warm codes back in (admission-checked)
  ======  ==========================================================

  The warm twin — an IVF-BQ index built on the card from the tenant's own
  rows — is built once at registration and stays resident while the
  tenant is HOT, so a demotion drops arrays and never builds on the
  eviction path.

* :class:`CapacityController` — every tenant dispatch projects its
  ``costmodel.estimate_search`` transient against the **predicted
  resident bytes** of the registry and the memory budget: ADMIT
  dispatches; QUEUE serves the warm tier degraded where its codes are
  resident, else holds under the caller's deadline; REJECT demotes
  least-recently-served tenants by the verdict's ``shortfall_bytes``,
  re-checks, and only then rejects classified (:class:`CapacityRejected`).
  Demotions are bounded per window (``RAFT_TPU_CAPACITY_MAX_DEMOTIONS``
  per ``RAFT_TPU_CAPACITY_WINDOW_S``); promotion restores a snapshot
  through the ``serving.capacity.promote`` faultpoint under its own
  deadline (``RAFT_TPU_CAPACITY_PROMOTE_DEADLINE_S``), with the measured
  latency recorded.

Snapshots go through the port's ``core/serialize`` (v2, written by
``core/fsio``). Every build and load — the warm twin, a promoted index or
store — runs on the controller's device (``device=`` / ``res=``, ``cuda``
unless the caller asks for the CPU). A failure is classified and recorded;
none runs a plain twin or the CPU in place of the failed call.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from raft_tpu_torch import obs, resilience
from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.obs import costmodel
from raft_tpu_torch.resilience.retry import record_event

__all__ = [
    "COLD",
    "HOT",
    "MAX_DEMOTIONS_ENV",
    "PROMOTE_DEADLINE_ENV",
    "WARM",
    "WINDOW_ENV",
    "CapacityController",
    "CapacityRejected",
    "Tenant",
    "TenantRegistry",
    "TenantResult",
    "default_max_demotions",
    "default_promote_deadline",
    "default_window_s",
]

HOT, WARM, COLD = "hot", "warm", "cold"
TIERS = (HOT, WARM, COLD)

MAX_DEMOTIONS_ENV = "RAFT_TPU_CAPACITY_MAX_DEMOTIONS"
WINDOW_ENV = "RAFT_TPU_CAPACITY_WINDOW_S"
PROMOTE_DEADLINE_ENV = "RAFT_TPU_CAPACITY_PROMOTE_DEADLINE_S"

#: request verdict the QueryQueue stamps on a capacity-rejected request —
#: a FIRST-CLASS classified outcome (obs/report counts it as known, never
#: unclassified residue)
REJECTED = "rejected"


def _env_pos(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    try:
        v = float(raw) if raw else default
    except ValueError:
        v = default
    return max(v, 0.0)


def default_max_demotions() -> int:
    """Demotions allowed per window (anti-thrash bound; the satellite
    livelock property test pins it)."""
    return int(_env_pos(MAX_DEMOTIONS_ENV, 8))


def default_window_s() -> float:
    """The demotion-rate window in seconds."""
    return _env_pos(WINDOW_ENV, 1.0) or 1.0


def default_promote_deadline() -> float:
    """Wall-clock bound on one snapshot restore (promotion); a hang on
    the device lands as a classified DEADLINE verdict."""
    return _env_pos(PROMOTE_DEADLINE_ENV, 30.0) or 30.0


class CapacityRejected(RuntimeError):
    """A dispatch the admission controller refused after attempting an
    eviction: the predicted footprint does not fit the budget even with
    least-recently-served tenants demoted. First-class ``rejected``
    verdict — NOT an OOM (the whole point is that the device allocator
    never saw the dispatch)."""


class TenantResult(tuple):
    """A ``(distances, indices)`` pair with tiering metadata riding
    along (the distributed ``SearchResult`` shape): unpacks as the plain
    2-tuple; degraded-mode consumers read ``degraded`` / ``tier`` /
    ``tenant``. Warm-tier results ALWAYS carry ``degraded=True`` — the
    shadow/SLO plane is what attributes the recall hit."""

    def __new__(cls, distances, indices, tenant: str, tier: str,
                degraded: bool = False):
        self = tuple.__new__(cls, (distances, indices))
        self.tenant = str(tenant)
        self.tier = str(tier)
        self.degraded = bool(degraded)
        return self

    @property
    def distances(self):
        return self[0]

    @property
    def indices(self):
        return self[1]


# ---------------------------------------------------------------------------
# tenants + registry
# ---------------------------------------------------------------------------


class Tenant:
    """One named namespace: the resident objects per tier, their
    predicted byte costs, the snapshot paths, and serving stats."""

    def __init__(self, name: str, kind: str, snapshot_dir: str):
        self.name = name
        self.kind = kind
        self.snapshot_dir = snapshot_dir
        # the tenant's own leaf lock: serving threads bump stats while the
        # promotion worker swaps tiers — every multi-field transition goes
        # through the mutator methods below. Registration-time writes in
        # TenantRegistry.register happen before the tenant is published
        # (construction phase; the registry dict insert is the barrier).
        self._lock = threading.Lock()
        self.tier = HOT                # guarded-by: _lock, reads-ok
        self.hot_obj = None            # guarded-by: _lock, reads-ok -- full index / paged store
        self.warm_index = None         # guarded-by: _lock, reads-ok -- IvfBqIndex (codes-only twin)
        self.warm_enabled = False      # tenant HAS a warm tier at all
        self.warm_ids: Optional[np.ndarray] = None  # guarded-by: _lock, reads-ok -- warm pos -> id
        self.hot_bytes = 0             # guarded-by: _lock, reads-ok -- predicted bytes of hot_obj
        self.warm_bytes = 0            # guarded-by: _lock, reads-ok -- predicted bytes of the twin
        self.search_fn: Optional[Callable] = None   # guarded-by: _lock, reads-ok
        self.last_served = 0.0         # guarded-by: _lock, reads-ok -- monotonic; the LRU key
        self.last_demoted = 0.0        # guarded-by: _lock, reads-ok
        self.serves = 0                # guarded-by: _lock, reads-ok
        self.degraded_serves = 0       # guarded-by: _lock, reads-ok
        self.demotions = 0             # guarded-by: _lock, reads-ok
        self.promotions = 0            # guarded-by: _lock, reads-ok
        self.verdicts: Dict[str, int] = {}   # guarded-by: _lock
        self.outcomes: Dict[str, int] = {}   # guarded-by: _lock -- ok/rejected/... counts
        self.lats: deque = deque(maxlen=256)  # guarded-by: _lock -- served latencies (s)
        # mutability across the tier cycle (paged-store tenants only):
        # WARM/COLD upserts buffer here and replay on promote; the page
        # plan preserves the store's compiled-shape envelope over the
        # demote→promote round trip (zero growth retraces mid-traffic)
        self.pending: list = []        # guarded-by: _lock -- [(rows f32, ids i64)] in arrival order
        self.pending_deletes: set = set()  # guarded-by: _lock -- ids whose latest op is a delete
        self.pending_rows = 0          # guarded-by: _lock, reads-ok
        self.page_plan: Optional[dict] = None  # guarded-by: _lock, reads-ok -- snapshot page layout

    # -- mutators (the only post-publication writers) -----------------------

    def touch(self) -> None:
        """Stamp the LRU eviction key with 'served now'."""
        with self._lock:
            self.last_served = time.monotonic()

    def record_verdict(self, verdict: str) -> None:
        with self._lock:
            self.verdicts[verdict] = self.verdicts.get(verdict, 0) + 1

    def record_serve(self, dt: float) -> None:
        """One successful hot/warm serve: count, outcome, latency sample."""
        with self._lock:
            self.serves += 1
            self.outcomes["ok"] = self.outcomes.get("ok", 0) + 1
            self.lats.append(dt)

    def record_outcome(self, outcome: str) -> None:
        with self._lock:
            self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1

    def record_degraded(self) -> None:
        with self._lock:
            self.degraded_serves += 1

    def set_search_fn(self, fn: Optional[Callable]) -> None:
        with self._lock:
            self.search_fn = fn

    def adopt_warm(self, warm, ids, warm_bytes: int) -> None:
        """Install loaded warm codes (COLD tenants step up to WARM)."""
        with self._lock:
            self.warm_index = warm
            self.warm_ids = ids
            self.warm_bytes = int(warm_bytes)
            if self.tier == COLD:
                self.tier = WARM

    def adopt_hot(self, hot, hot_bytes: int) -> None:
        """Install a promoted hot object: tier up + count the promotion."""
        with self._lock:
            self.hot_obj = hot
            self.hot_bytes = int(hot_bytes)
            self.tier = HOT
            self.promotions += 1

    # -- mutability across the tier cycle -----------------------------------

    def apply_upsert(self, vectors, ids=None) -> dict:
        """Accept an upsert at ANY tier. HOT applies straight to the live
        paged store (under the tenant lock, so a concurrent demotion's
        hibernation snapshot can never lose the rows); WARM/COLD buffers
        the batch for replay at the next promote — those rows still serve
        (exactly) through the warm tier's pending merge. Buffered rows
        REQUIRE explicit ids: auto-assignment is only stable against the
        live store."""
        rows = np.asarray(vectors, dtype=np.float32)
        if rows.ndim != 2:
            raise ValueError(f"vectors must be 2-D, got shape {rows.shape}")
        with self._lock:
            if self.tier == HOT and self.hot_obj is not None:
                if not hasattr(self.hot_obj, "upsert"):
                    raise TypeError(
                        f"tenant {self.name!r} ({self.kind}) serves a "
                        f"packed index — register a paged store for live "
                        f"mutation")
                self.hot_obj.upsert(rows, ids)
                return {"tier": HOT, "applied": int(rows.shape[0]),
                        "buffered": 0}
            if self.kind != "paged_store":
                raise TypeError(
                    f"tenant {self.name!r} ({self.kind}) is immutable — "
                    f"only paged-store tenants accept upserts across the "
                    f"tier cycle")
            if ids is None:
                raise ValueError(
                    f"tenant {self.name!r} is {self.tier} — buffered "
                    f"upserts require explicit ids")
            ids_np = np.asarray(ids, dtype=np.int64).reshape(-1)
            if ids_np.shape[0] != rows.shape[0]:
                raise ValueError(
                    f"ids shape {ids_np.shape} does not match "
                    f"{rows.shape[0]} rows")
            # an upsert supersedes any earlier buffered delete of its id
            self.pending_deletes.difference_update(ids_np.tolist())
            self.pending.append((rows, ids_np))
            self.pending_rows += int(rows.shape[0])
            return {"tier": self.tier, "applied": 0,
                    "buffered": int(rows.shape[0])}

    def apply_delete(self, ids) -> dict:
        """Delete at ANY tier: HOT tombstones in the live store; WARM/COLD
        drops matching buffered rows and records the ids for replay."""
        ids_np = np.unique(np.asarray(ids, dtype=np.int64).reshape(-1))
        with self._lock:
            if self.tier == HOT and self.hot_obj is not None:
                if not hasattr(self.hot_obj, "delete"):
                    raise TypeError(
                        f"tenant {self.name!r} ({self.kind}) serves a "
                        f"packed index — register a paged store for live "
                        f"mutation")
                removed = int(self.hot_obj.delete(ids_np))
                return {"tier": HOT, "removed": removed, "buffered": 0}
            if self.kind != "paged_store":
                raise TypeError(
                    f"tenant {self.name!r} ({self.kind}) is immutable — "
                    f"only paged-store tenants accept deletes across the "
                    f"tier cycle")
            dropped = 0
            batches = []
            for rows, bids in self.pending:
                keep = ~np.isin(bids, ids_np)
                dropped += int(bids.size - keep.sum())
                if keep.all():
                    batches.append((rows, bids))
                elif keep.any():
                    batches.append((rows[keep], bids[keep]))
            self.pending = batches
            self.pending_rows -= dropped
            self.pending_deletes.update(ids_np.tolist())
            return {"tier": self.tier, "removed": dropped,
                    "buffered": int(ids_np.size)}

    def pending_view(self) -> Optional[tuple]:
        """Deduplicated snapshot of the buffered mutations for the warm
        tier's exact merge: ``(rows, ids, deletes)`` with keep-LAST id
        semantics (a later upsert supersedes); None when nothing is
        pending."""
        with self._lock:
            if not self.pending and not self.pending_deletes:
                return None
            batches = list(self.pending)
            deletes = set(self.pending_deletes)
        if batches:
            rows = np.concatenate([b[0] for b in batches])
            ids_np = np.concatenate([b[1] for b in batches])
            _, last_rev = np.unique(ids_np[::-1], return_index=True)
            keep = np.sort(ids_np.size - 1 - last_rev)
            rows, ids_np = rows[keep], ids_np[keep]
        else:
            rows = ids_np = None
        return rows, ids_np, deletes

    def drain_pending(self) -> tuple:
        """Atomically take (and clear) the buffered mutations —
        ``(batches, deletes)`` for replay into a freshly promoted store.
        Upserts replay in arrival order before the deletes (the buffer
        invariants make that ordering exact: an id in ``deletes`` has no
        buffered row, and a re-upserted id left ``deletes`` on arrival)."""
        with self._lock:
            batches = self.pending
            deletes = sorted(self.pending_deletes)
            self.pending = []
            self.pending_deletes = set()
            self.pending_rows = 0
        return batches, deletes

    def demote_one_tier(self, now: float, snapshot_cb=None) -> Optional[dict]:
        """One atomic tier-down transition; returns the demotion record
        (None when the tenant already holds nothing). HOT drops the full
        index (warm codes stay resident — the instant path); WARM drops
        the codes. ``snapshot_cb(hot_obj)`` runs BEFORE the drop, under
        the tenant lock (mutually exclusive with :meth:`apply_upsert`, so
        a hibernation snapshot can never miss accepted rows); its return
        value becomes the tenant's ``page_plan``."""
        with self._lock:
            if self.tier == HOT:
                if snapshot_cb is not None and self.hot_obj is not None:
                    plan = snapshot_cb(self.hot_obj)
                    if plan is not None:
                        self.page_plan = plan
                freed = self.hot_bytes if self.hot_obj is not None else 0
                self.hot_obj = None
                to = WARM if self.warm_index is not None else COLD
                if to == COLD and self.warm_index is not None:
                    freed += self.warm_bytes
                    self.warm_index = None
            elif self.tier == WARM:
                freed = self.warm_bytes if self.warm_index is not None else 0
                self.warm_index = None
                to = COLD
            else:
                return None
            rec = {"tenant": self.name, "from": self.tier, "to": to,
                   "freed_bytes": int(freed)}
            self.tier = to
            self.demotions += 1
            self.last_demoted = now
        return rec

    @property
    def hot_path(self) -> str:
        return os.path.join(self.snapshot_dir, f"{self.name}.hot.raft")

    @property
    def warm_path(self) -> str:
        return os.path.join(self.snapshot_dir, f"{self.name}.warm.raft")

    @property
    def warm_ids_path(self) -> str:
        return os.path.join(self.snapshot_dir, f"{self.name}.warm_ids.raft")

    def resident_bytes(self) -> int:
        """Predicted bytes this tenant holds resident at its current tier
        (HOT keeps the warm codes too — the always-resident demotion
        fast path)."""
        with self._lock:
            total = 0
            if self.hot_obj is not None:
                total += self.hot_bytes
            if self.warm_index is not None:
                total += self.warm_bytes
            return total

    def slo_row(self) -> dict:
        """Per-tenant SLO row: serve counts by outcome + latency
        percentiles over the recent window (the per-tenant half of the
        acceptance's 'per-tenant SLO rows exported')."""
        with self._lock:
            row = {
                "served": int(self.serves),
                "degraded": int(self.degraded_serves),
                **{k: int(v) for k, v in sorted(self.outcomes.items())},
            }
            lats = (np.asarray(self.lats, dtype=np.float64)
                    if self.lats else None)
        if lats is not None:
            row["p50_ms"] = round(float(np.percentile(lats, 50)) * 1e3, 3)
            row["p99_ms"] = round(float(np.percentile(lats, 99)) * 1e3, 3)
        return row


def _family_of(index) -> str:
    """The costmodel family kind of a registered object (also validates
    that the capacity plane knows how to predict its residency)."""
    layout = costmodel.index_layout(index)
    return layout["kind"]


def _host(x) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    if hasattr(x, "cpu"):
        return x.cpu().numpy()
    return np.asarray(x)


def _extract_rows(index) -> Tuple[np.ndarray, np.ndarray]:
    """(rows, ids) of the raw vectors an index still carries — the warm
    twin's training set. Families that keep no raw rows (ivf_pq codes)
    raise; their tenants tier HOT→COLD directly unless a ``warm_index``
    was supplied at registration."""
    from raft_tpu_torch.neighbors import brute_force as bf_mod
    from raft_tpu_torch.neighbors import cagra as cagra_mod
    from raft_tpu_torch.neighbors import ivf_flat as flat_mod
    from raft_tpu_torch.serving.store import PagedListStore

    if isinstance(index, PagedListStore):
        return _extract_rows(index.compact())
    if isinstance(index, flat_mod.IvfFlatIndex):
        data = _host(index.list_data).reshape(-1, index.dim)
        ids = _host(index.list_ids).reshape(-1)
        live = ids >= 0
        return data[live].astype(np.float32), ids[live].astype(np.int64)
    if isinstance(index, (bf_mod.BruteForceIndex, cagra_mod.CagraIndex)):
        data = _host(index.dataset).astype(np.float32)
        return data, np.arange(data.shape[0], dtype=np.int64)
    raise TypeError(
        f"{type(index).__name__} carries no raw rows to derive a warm BQ "
        f"twin from — pass warm_index= at registration (or accept "
        f"HOT→COLD demotion)")


def _warm_twin(index, warm_params=None, res: Optional[Resources] = None):
    """Build the tenant's warm tier on ``res``'s device: an IvfBqIndex over
    the index's own rows (sign codes at bits·rot_dim/8 bytes a row) plus
    the host-side position→source-id map its degraded results translate
    through."""
    from raft_tpu_torch.neighbors import ivf_bq

    rows, ids = _extract_rows(index)
    n = int(rows.shape[0])
    if n < 1:
        raise ValueError("cannot build a warm twin over an empty index")
    if warm_params is None:
        metric = getattr(index, "metric", "sqeuclidean")
        if metric not in ivf_bq.SUPPORTED_METRICS:
            metric = "sqeuclidean"
        warm_params = ivf_bq.IvfBqParams(
            n_lists=max(1, min(32, n // 64)), metric=metric,
            kmeans_n_iters=5, list_size_cap=0)
    warm = ivf_bq.build(rows, warm_params, res=res)
    return warm, ids


def _merge_pending(queries, vals, ids, k, metric, rows_p, ids_p,
                   deletes) -> Tuple[np.ndarray, np.ndarray]:
    """Fold a tenant's buffered mutations into a warm-tier result: mask
    pending-deleted ids out, score the pending rows EXACTLY (they are
    fp32 in the buffer — no BQ quantization), and re-select top-k over
    the union. Keeps the degraded serve read-your-writes: a row upserted
    while the tenant is WARM is visible to the very next query."""
    bigger = metric == "inner_product"   # brute_force._MAX_METRICS shape
    worst = -np.inf if bigger else np.inf
    vals = np.where(ids < 0, worst, vals)   # pads must never win a merge
    if deletes:
        dead = np.isin(ids, np.fromiter(deletes, dtype=np.int64))
        vals = np.where(dead, worst, vals)
        ids = np.where(dead, -1, ids)
    if rows_p is not None:
        q = np.ascontiguousarray(queries, dtype=np.float32)
        ip = q @ rows_p.T
        if metric == "inner_product":
            scores = ip
        elif metric == "cosine":
            qn = np.linalg.norm(q, axis=1, keepdims=True)
            rn = np.linalg.norm(rows_p, axis=1)[None, :]
            scores = 1.0 - ip / np.maximum(qn * rn, 1e-30)
        else:
            d = np.maximum((q ** 2).sum(1, keepdims=True)
                           + (rows_p ** 2).sum(1)[None, :] - 2.0 * ip, 0.0)
            scores = np.sqrt(d) if metric == "euclidean" else d
        vals = np.concatenate([vals, scores.astype(vals.dtype)], axis=1)
        ids = np.concatenate(
            [ids, np.broadcast_to(ids_p, scores.shape).astype(ids.dtype)],
            axis=1)
    order = np.argsort(-vals if bigger else vals, axis=1,
                       kind="stable")[:, :k]
    return (np.take_along_axis(vals, order, axis=1),
            np.take_along_axis(ids, order, axis=1))


def _default_search_fn(kind: str, res: Optional[Resources] = None) -> Callable:
    """Hot-tier dispatch for the families the plane serves natively, on
    ``res``'s device."""
    def run(obj, queries, k, n_probes=20, **kw):
        kw.setdefault("res", res)
        from raft_tpu_torch.neighbors import brute_force as bf_mod
        from raft_tpu_torch.neighbors import ivf_bq, ivf_flat, ivf_pq

        if kind == "paged_store":
            from raft_tpu_torch import serving

            return serving.search(obj, queries, k, n_probes=n_probes, **kw)
        if kind == "brute_force":
            return bf_mod.search(obj, queries, k, **kw)
        fam = {"ivf_flat": ivf_flat, "ivf_pq": ivf_pq, "ivf_bq": ivf_bq}[kind]
        return fam.search(obj, queries, k, n_probes=n_probes, **kw)

    return run


class TenantRegistry:
    """Thread-safe bookkeeping of the named tenants: tier state, the
    predicted residency ledger, and LRU ordering. Policy (admission,
    eviction sizing, promotion) lives in :class:`CapacityController`."""

    def __init__(self):
        self._lock = threading.RLock()
        self._tenants: Dict[str, Tenant] = {}

    def register(self, name: str, index, snapshot_dir,
                 warm_index=None, warm_ids=None, warm_params=None,
                 warm: bool = True,
                 search_fn: Optional[Callable] = None,
                 save_snapshots: bool = True,
                 res: Optional[Resources] = None) -> Tenant:
        """Create tenant ``name`` over ``index``: predicts its per-tier
        residency, builds the warm BQ twin (unless supplied or
        underivable), and writes the hot + warm v2 snapshots that
        demotion relies on (a tier drop must never lose the only copy).
        Registration is the expensive, off-serving-path moment — demote
        and promote only move already-prepared artifacts."""
        name = str(name)
        snapshot_dir = os.fspath(snapshot_dir)
        with self._lock:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
        kind = _family_of(index)
        tenant = Tenant(name, kind, snapshot_dir)
        tenant.hot_obj = index
        tenant.hot_bytes = costmodel.predict_index_bytes(
            **costmodel.index_layout(index))
        tenant.search_fn = search_fn or _default_search_fn(kind, res)
        if warm_index is None and warm:
            try:
                warm_index, warm_ids = _warm_twin(index, warm_params,
                                                  resources_for(None, res))
            except TypeError:
                warm_index = None  # no raw rows: HOT→COLD tenant
        if warm_index is not None:
            tenant.warm_index = warm_index
            tenant.warm_enabled = True
            tenant.warm_ids = (np.asarray(warm_ids, dtype=np.int64)
                               if warm_ids is not None else None)
            tenant.warm_bytes = costmodel.predict_index_bytes(
                **costmodel.index_layout(warm_index))
        if save_snapshots:
            self._save_snapshots(tenant, index)
        tenant.touch()
        with self._lock:
            # re-check at insert: a concurrent same-name registration
            # must lose LOUDLY, not silently replace the winner's ledger
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
            self._tenants[name] = tenant
        if obs.enabled():
            obs.add("capacity.tenants.registered")
        return tenant

    def _save_snapshots(self, tenant: Tenant, index) -> None:
        from raft_tpu_torch.core.serialize import save_arrays
        from raft_tpu_torch.serving.store import PagedListStore

        os.makedirs(tenant.snapshot_dir, exist_ok=True)
        hot = index.compact() if isinstance(index, PagedListStore) else index
        hot.save(tenant.hot_path)
        if tenant.warm_index is not None:
            tenant.warm_index.save(tenant.warm_path)
            if tenant.warm_ids is not None:
                save_arrays(tenant.warm_ids_path,
                            {"kind": "capacity_warm_ids",
                             "tenant": tenant.name},
                            {"ids": tenant.warm_ids})

    def get(self, name: str) -> Tenant:
        with self._lock:
            try:
                return self._tenants[name]
            except KeyError:
                raise KeyError(f"unknown tenant {name!r} "
                               f"(have {sorted(self._tenants)})") from None

    def remove(self, name: str) -> None:
        with self._lock:
            self._tenants.pop(name, None)

    def names(self) -> list:
        with self._lock:
            return sorted(self._tenants)

    def tenants(self) -> list:
        with self._lock:
            return list(self._tenants.values())

    def touch(self, name: str) -> None:
        self.get(name).touch()

    def resident_bytes(self) -> int:
        """The budgeter's ledger: predicted resident bytes across every
        tenant at its current tier — the ``bytes_in_use`` the controller
        projects dispatches against (deterministic, synthetic-budget
        friendly: the plane accounts what it registered, not whatever
        else the process holds)."""
        with self._lock:
            return sum(t.resident_bytes() for t in self._tenants.values())

    def lru(self, exclude=()) -> list:
        """Demotion candidates, least-recently-served first (COLD tenants
        hold nothing to free and are skipped)."""
        exclude = set(exclude)
        with self._lock:
            cands = [t for t in self._tenants.values()
                     if t.name not in exclude and t.tier != COLD]
        return sorted(cands, key=lambda t: t.last_served)

    def tier_counts(self) -> dict:
        with self._lock:
            counts = {HOT: 0, WARM: 0, COLD: 0}
            for t in self._tenants.values():
                counts[t.tier] += 1
            return counts


# ---------------------------------------------------------------------------
# the acting controller
# ---------------------------------------------------------------------------


class CapacityController:
    """Binding admission + tiered residency over a :class:`TenantRegistry`.

    ``budget_bytes``: the HBM budget the registry is packed against
    (default: :func:`obs.costmodel.hbm_budget` — the
    ``RAFT_TPU_OBS_HBM_BYTES`` override or the device allocator limit;
    0/unknown admits everything, recorded). All admission projections use
    the registry's PREDICTED resident bytes as ``bytes_in_use``.
    """

    def __init__(self, registry: Optional[TenantRegistry] = None, *,
                 budget_bytes: Optional[int] = None,
                 max_demotions: Optional[int] = None,
                 window_s: Optional[float] = None,
                 promote_deadline_s: Optional[float] = None,
                 res: Optional[Resources] = None,
                 device: Optional[DeviceLike] = None):
        # the device every warm-twin build and promotion load runs on
        self.res = resources_for(device, res)
        self.registry = registry or TenantRegistry()
        if budget_bytes is not None:
            self.budget_bytes = int(budget_bytes)
            self.budget_source = "caller"
        else:
            budget = costmodel.hbm_budget()
            self.budget_bytes = int(budget["bytes"])
            self.budget_source = budget["source"]
        self.max_demotions = (int(max_demotions) if max_demotions is not None
                              else default_max_demotions())
        self.window_s = (float(window_s) if window_s is not None
                         else default_window_s())
        self.promote_deadline_s = (
            float(promote_deadline_s) if promote_deadline_s is not None
            else default_promote_deadline())
        self._lock = threading.RLock()
        self._demotion_times: deque = deque(maxlen=max(self.max_demotions, 1))
        self._promote_lats: deque = deque(maxlen=256)
        self._counts = {"demotions": 0, "promotions": 0, "rejections": 0,
                        "promote_failures": 0, "promote_denied": 0,
                        "queued_degraded": 0, "upserts": 0, "deletes": 0,
                        "buffered_upserts": 0, "replays": 0}

    # -- registration -------------------------------------------------------
    def register(self, name: str, index, snapshot_dir, **kw) -> Tenant:
        """Admission-placed registration: the tenant lands HOT when its
        full residency fits the budget (after an eviction attempt), WARM
        when only the codes fit, COLD otherwise — a registry growing past
        its budget degrades tier by tier instead of overcommitting."""
        with obs.record_span("capacity::register",
                             attrs={"tenant": str(name)}
                             if obs.enabled() else None):
            kw.setdefault("res", self.res)
            tenant = self.registry.register(name, index, snapshot_dir, **kw)
            # the tenant is ALREADY in the ledger — project the ledger as
            # it stands (predicted delta 0), not its bytes a second time
            rec = self._admission(0, entry="capacity.register")
            if rec["verdict"] == costmodel.REJECT:
                self.make_room(rec.get("shortfall_bytes", 0),
                               exclude=(tenant.name,))
                rec = self._admission(0, entry="capacity.register")
            if rec["verdict"] != costmodel.ADMIT:
                self._demote_one(tenant)          # HOT -> WARM (or COLD)
                if tenant.tier == WARM and self._admission(
                        0, entry="capacity.register")["verdict"] \
                        != costmodel.ADMIT:
                    self._demote_one(tenant)      # WARM -> COLD
            return tenant

    # -- admission ----------------------------------------------------------
    def _admission(self, predicted, entry: str) -> dict:
        return costmodel.check_admission(
            predicted, entry=entry,
            budget_bytes=self.budget_bytes or None,
            bytes_in_use=self.registry.resident_bytes())

    def admit(self, predicted, entry: str = "", tenant: str = "") -> dict:
        """The BINDING verdict for one predicted footprint: checks
        admission against the budgeter's ledger; a REJECT first sizes an
        eviction from the verdict's ``shortfall_bytes``, demotes
        least-recently-served tenants (never the requesting one), and
        re-checks. The returned record's verdict is final — the caller
        dispatches (admit), holds/degrades (queue) or rejects classified
        (reject)."""
        with obs.record_span("capacity::admit",
                             attrs={"entry": entry} if obs.enabled()
                             else None):
            with self._lock:
                rec = self._admission(predicted, entry)
                if rec["verdict"] == costmodel.REJECT:
                    demoted = self.make_room(
                        rec.get("shortfall_bytes") or rec["predicted_bytes"],
                        exclude=(tenant,) if tenant else ())
                    if demoted:
                        rec = self._admission(predicted, entry)
                        rec["demoted"] = [d["tenant"] for d in demoted]
            if tenant:
                try:
                    self.registry.get(tenant).record_verdict(rec["verdict"])
                except KeyError:
                    pass
            if obs.enabled():
                obs.add(f"capacity.verdict.{rec['verdict']}")
            return rec

    def cost_model_for(self, name: str, k: int, n_probes: int) -> Callable:
        """``batch_size -> estimate dict`` over tenant ``name``'s CURRENT
        hot/warm object — the ``QueryQueue(cost_model=...)`` hook for a
        capacity-managed queue (pair it with ``capacity=controller`` to
        make the verdicts binding)."""

        def cost(batch: int) -> dict:
            tenant = self.registry.get(name)
            obj = tenant.hot_obj if tenant.hot_obj is not None \
                else tenant.warm_index
            if obj is None:
                return {"transient_bytes": 0, "total_bytes": 0}
            return costmodel.estimate_search(obj, q=int(batch), k=k,
                                             n_probes=n_probes)

        return cost

    # -- mutation (any tier) -------------------------------------------------
    def upsert(self, name: str, vectors, ids=None) -> dict:
        """Upsert rows into tenant ``name`` at WHATEVER tier it occupies:
        HOT applies to the live paged store; WARM/COLD buffers for replay
        at promote (explicit ids required) while the warm tier serves the
        buffered rows exactly. A HOT apply re-predicts the ledger — live
        growth changes every later admission projection."""
        tenant = self.registry.get(name)
        attrs = {"tenant": name, "tier": tenant.tier} \
            if obs.enabled() else None
        with obs.record_span("capacity::upsert", attrs=attrs):
            rec = tenant.apply_upsert(vectors, ids)
            if rec["applied"] and tenant.hot_obj is not None:
                with tenant._lock:
                    tenant.hot_bytes = costmodel.predict_index_bytes(
                        **costmodel.index_layout(tenant.hot_obj))
            with self._lock:
                self._counts["upserts"] += 1
                if rec["buffered"]:
                    self._counts["buffered_upserts"] += 1
            if obs.enabled():
                obs.add("capacity.upserts")
                if rec["buffered"]:
                    obs.add("capacity.upserts.buffered")
            if rec["buffered"]:
                record_event("capacity_upsert_buffered", tenant=name,
                             tier=rec["tier"], rows=rec["buffered"])
            return rec

    def delete(self, name: str, ids) -> dict:
        """Delete ids from tenant ``name`` at any tier (the buffered half
        mirrors :meth:`upsert`)."""
        tenant = self.registry.get(name)
        attrs = {"tenant": name, "tier": tenant.tier} \
            if obs.enabled() else None
        with obs.record_span("capacity::delete", attrs=attrs):
            rec = tenant.apply_delete(ids)
            with self._lock:
                self._counts["deletes"] += 1
            if obs.enabled():
                obs.add("capacity.deletes")
            return rec

    # -- eviction (tier-down) -----------------------------------------------
    def _window_demotions(self, now: float) -> int:
        return sum(1 for t in self._demotion_times
                   if now - t <= self.window_s)

    def _hibernate_paged(self, tenant: Tenant) -> Optional[Callable]:
        """The HOT→WARM snapshot callback for a paged (mutable) tenant:
        compact the live store, overwrite the hot snapshot with its
        CURRENT rows (the registration-time snapshot is stale the moment
        the first upsert lands), and capture the page plan —
        ``restore_shape`` on promote re-creates the same compiled-shape
        envelope so the round trip costs zero growth retraces. Non-paged
        tenants return None: their registration snapshot is still exact."""
        if tenant.kind != "paged_store":
            return None

        def snap(hot_obj) -> Optional[dict]:
            from raft_tpu_torch.serving.store import PagedListStore

            if not isinstance(hot_obj, PagedListStore):
                return None
            packed = hot_obj.compact()
            packed.save(tenant.hot_path)
            if obs.enabled():
                obs.add("capacity.hibernates")
            record_event("capacity_hibernate", tenant=tenant.name,
                         rows=int(hot_obj.size))
            return {"kind": _family_of(packed),
                    "page_rows": int(hot_obj.page_rows),
                    "capacity_pages": int(hot_obj.capacity_pages),
                    "table_width": int(hot_obj.table_width)}

        return snap

    def _demote_one(self, tenant: Tenant) -> Optional[dict]:
        """One tier down; returns the demotion record (None when the
        tenant already holds nothing). HOT drops the full index (the warm
        codes stay resident — the instant path); WARM drops the codes. A
        paged tenant hibernates first (fresh snapshot + page plan); a
        FAILED hibernation aborts the demotion classified — dropping the
        only copy of accepted mutations is never an eviction option."""
        now = time.monotonic()
        try:
            rec = tenant.demote_one_tier(
                now, snapshot_cb=self._hibernate_paged(tenant))
        except Exception as e:
            kind = resilience.classify(e)
            if obs.enabled():
                obs.add("capacity.demote.failed")
                obs.add(f"capacity.demote.failed.{kind}")
            record_event("capacity_demote_failed", tenant=tenant.name,
                         kind=kind, error=repr(e)[:200])
            return None
        if rec is None:
            return None
        with self._lock:
            self._counts["demotions"] += 1
            self._demotion_times.append(now)
        if obs.enabled():
            obs.add("capacity.demotions")
            obs.add(f"capacity.tenant.{tenant.name}.demotions")
        record_event("capacity_demote", **rec)
        return rec

    def demote(self, name: str) -> Optional[dict]:
        """Demote tenant ``name`` one tier (public entry; eviction sizing
        goes through :meth:`make_room`)."""
        with obs.record_span("capacity::demote",
                             attrs={"tenant": name} if obs.enabled()
                             else None):
            return self._demote_one(self.registry.get(name))

    def make_room(self, shortfall_bytes: int, exclude=()) -> list:
        """Free at least ``shortfall_bytes`` predicted bytes by demoting
        least-recently-served tenants tier-down. Bounded by the
        per-window demotion budget (anti-livelock): when the window is
        exhausted the eviction stops short, classified — the caller's
        re-check then rejects rather than thrashing the registry."""
        shortfall = int(shortfall_bytes)
        if shortfall <= 0:
            return []
        demoted = []
        freed = 0
        with self._lock:
            # multi-pass: one tier step per tenant per pass (spreads the
            # pain — WARM everywhere before COLD anywhere), repeated
            # until the shortfall is covered, the window budget runs out,
            # or nothing is left to free
            while freed < shortfall:
                now = time.monotonic()
                progressed = False
                for tenant in self.registry.lru(exclude=exclude):
                    if freed >= shortfall:
                        break
                    if self._window_demotions(now) >= self.max_demotions:
                        record_event("capacity_demotion_limited",
                                     shortfall_bytes=shortfall - freed,
                                     window_s=self.window_s,
                                     max_demotions=self.max_demotions)
                        if obs.enabled():
                            obs.add("capacity.demotions.limited")
                        return demoted
                    rec = self._demote_one(tenant)
                    if rec is not None:
                        demoted.append(rec)
                        freed += rec["freed_bytes"]
                        progressed = True
                if not progressed:
                    break
        return demoted

    # -- promotion (tier-up) -------------------------------------------------
    def _load_hot(self, tenant: Tenant):
        """Reload the packed hot index from the tenant's v2 snapshot (the
        serialize.load.read faultpoint inside load_arrays covers the
        read)."""
        from raft_tpu_torch.neighbors import brute_force as bf_mod
        from raft_tpu_torch.neighbors import cagra as cagra_mod
        from raft_tpu_torch.neighbors import ivf_bq, ivf_flat, ivf_pq

        cls = {"ivf_flat": ivf_flat.IvfFlatIndex,
               "ivf_pq": ivf_pq.IvfPqIndex,
               "ivf_bq": ivf_bq.IvfBqIndex,
               "brute_force": bf_mod.BruteForceIndex,
               "cagra": cagra_mod.CagraIndex}.get(tenant.kind)
        if cls is None:
            # a paged store compacts to ivf_flat/pq/bq for its snapshot;
            # a paged TENANT rehydrates back to a PagedListStore on the
            # hibernation page plan — mutability survives the tier cycle
            from raft_tpu_torch.core.serialize import load_arrays

            meta, _ = load_arrays(tenant.hot_path)
            kind = meta.get("kind")
            cls = {"ivf_flat": ivf_flat.IvfFlatIndex,
                   "ivf_pq": ivf_pq.IvfPqIndex,
                   "ivf_bq": ivf_bq.IvfBqIndex}[kind]
            packed = cls.load(tenant.hot_path, res=self.res)
            if tenant.kind == "paged_store":
                from raft_tpu_torch.serving.store import PagedListStore

                plan = tenant.page_plan or {}
                store = PagedListStore.from_index(
                    packed, page_rows=plan.get("page_rows"), res=self.res)
                store.restore_shape(plan.get("capacity_pages", 0),
                                    plan.get("table_width", 0))
                return store
            tenant.set_search_fn(_default_search_fn(kind, self.res))
            return packed
        return cls.load(tenant.hot_path, res=self.res)

    def _load_warm(self, tenant: Tenant) -> None:
        """Page the warm codes back in from the warm snapshot (COLD →
        WARM): the small, admission-checked read that lets a cold tenant
        serve degraded while the full promote happens off the hot path."""
        from raft_tpu_torch.core.serialize import load_arrays
        from raft_tpu_torch.neighbors import ivf_bq

        if not os.path.exists(tenant.warm_path):
            raise FileNotFoundError(
                f"tenant {tenant.name!r} has no warm snapshot at "
                f"{tenant.warm_path} — it cannot serve degraded; promote "
                f"it instead")
        warm = ivf_bq.IvfBqIndex.load(tenant.warm_path, res=self.res)
        ids = None
        if os.path.exists(tenant.warm_ids_path):
            _, arrays = load_arrays(tenant.warm_ids_path)
            ids = np.asarray(arrays["ids"], dtype=np.int64)
        tenant.adopt_warm(warm, ids, costmodel.predict_index_bytes(
            **costmodel.index_layout(warm)))

    def promote(self, name: str) -> dict:
        """Restore tenant ``name``'s snapshot to full HOT residency with
        MEASURED hot-swap latency. Admission-gated (only an ADMIT
        promotes — the budgeter invariant survives the reverse path) and
        deadline-bounded through the faultpointed
        ``serving.capacity.promote`` site: an injected/real oom or hang
        lands classified and the tenant stays in its prior tier. Returns
        the classified record, never raises for classified failures."""
        tenant = self.registry.get(name)
        attrs = {"tenant": name, "tier": tenant.tier} \
            if obs.enabled() else None
        with obs.record_span("capacity::promote", attrs=attrs):
            if tenant.tier == HOT:
                return {"status": "noop", "tenant": name, "tier": HOT}
            delta = tenant.hot_bytes
            if tenant.warm_index is None and tenant.warm_enabled:
                delta += tenant.warm_bytes
            rec = self.admit(delta, entry="capacity.promote", tenant=name)
            if rec["verdict"] != costmodel.ADMIT:
                with self._lock:
                    self._counts["promote_denied"] += 1
                if obs.enabled():
                    obs.add("capacity.promote.denied")
                return {"status": "denied", "tenant": name,
                        "tier": tenant.tier, "verdict": rec["verdict"]}
            prior = tenant.tier
            t0 = time.perf_counter()
            try:
                with resilience.Deadline(self.promote_deadline_s,
                                         label="capacity.promote"):
                    resilience.faultpoint("serving.capacity.promote")
                    hot = self._load_hot(tenant)
                    if tenant.warm_index is None and tenant.warm_enabled:
                        self._load_warm(tenant)
            except Exception as e:
                kind = resilience.classify(e)
                with self._lock:
                    self._counts["promote_failures"] += 1
                if obs.enabled():
                    obs.add("capacity.promote.failed")
                    obs.add(f"capacity.promote.failed.{kind}")
                record_event("capacity_promote_failed", tenant=name,
                             kind=kind, error=repr(e)[:200])
                return {"status": "error", "tenant": name, "tier": prior,
                        "kind": kind, "error": repr(e)[:200]}
            dt = time.perf_counter() - t0
            # re-predict: the restored object can differ from what was
            # registered (a paged-store tenant promotes to its COMPACTED
            # packed snapshot) — a stale ledger entry would mis-project
            # every later admission
            tenant.adopt_hot(hot, costmodel.predict_index_bytes(
                **costmodel.index_layout(hot)))
            # mutations accepted while demoted replay into the restored
            # store AFTER the tier flip: once the tenant is HOT no new
            # batch can buffer, so one drain here catches everything
            replay = self._replay_pending(tenant)
            with self._lock:
                self._counts["promotions"] += 1
                self._promote_lats.append(dt)
            if obs.enabled():
                obs.add("capacity.promotions")
                obs.add(f"capacity.tenant.{name}.promotions")
                obs.observe("capacity.promote_s", dt)
            record_event("capacity_promote", tenant=name,
                         promote_s=round(dt, 6))
            return {"status": "ok", "tenant": name, "tier": HOT,
                    "promote_s": dt, "from": prior,
                    "replayed_rows": replay["rows"],
                    "replayed_deletes": replay["deletes"]}

    def _replay_pending(self, tenant: Tenant) -> dict:
        """Apply the drained WARM/COLD mutation buffer to the freshly
        promoted store: upsert batches in arrival order, then the
        tombstones (:meth:`Tenant.drain_pending` documents why that
        ordering is exact). The ledger re-predicts afterwards — replayed
        rows change the resident footprint."""
        batches, deletes = tenant.drain_pending()
        if not batches and not deletes:
            return {"rows": 0, "deletes": 0}
        store = tenant.hot_obj
        rows_n = 0
        try:
            for rows, ids_np in batches:
                store.upsert(rows, ids_np)
                rows_n += int(rows.shape[0])
            if deletes:
                store.delete(np.asarray(deletes, dtype=np.int64))
        except Exception as e:
            kind = resilience.classify(e)
            if obs.enabled():
                obs.add(f"capacity.replay.failed.{kind}")
            record_event("capacity_replay_failed", tenant=tenant.name,
                         kind=kind, error=repr(e)[:200])
            return {"rows": rows_n, "deletes": 0}
        with tenant._lock:
            tenant.hot_bytes = costmodel.predict_index_bytes(
                **costmodel.index_layout(store))
        with self._lock:
            self._counts["replays"] += 1
        if obs.enabled():
            obs.add("capacity.replays")
        record_event("capacity_replay", tenant=tenant.name, rows=rows_n,
                     deletes=len(deletes))
        return {"rows": rows_n, "deletes": len(deletes)}

    def autopromote(self, max_promotions: int = 1) -> list:
        """Opportunistic tier-up of the most-recently-served non-HOT
        tenants whose full residency ADMITs — the reverse path the chaos
        bench drives between request windows (off the hot path). Tenants
        demoted within the current window are skipped (anti-thrash)."""
        promoted = []
        now = time.monotonic()
        cands = sorted(
            (t for t in self.registry.tenants()
             if t.tier != HOT and t.serves > 0
             and now - t.last_demoted > self.window_s),
            key=lambda t: t.last_served, reverse=True)
        for tenant in cands:
            if len(promoted) >= max_promotions:
                break
            rec = self.promote(tenant.name)
            if rec.get("status") == "ok":
                promoted.append(rec)
        return promoted

    # -- serving -------------------------------------------------------------
    def _serve_warm(self, tenant: Tenant, queries, k: int,
                    n_probes: int) -> TenantResult:
        from raft_tpu_torch.neighbors import ivf_bq

        warm = tenant.warm_index
        np_warm = max(1, min(int(n_probes), warm.n_lists))
        kw = min(int(k), min(np_warm * warm.max_list_size, 512))
        vals, ids = ivf_bq.search(warm, queries, kw, n_probes=np_warm,
                                  res=self.res)
        vals = _host(vals)
        ids = _host(ids)
        if tenant.warm_ids is not None:
            live = ids >= 0
            out_ids = np.full(ids.shape, -1, dtype=np.int64)
            out_ids[live] = tenant.warm_ids[ids[live]]
            ids = out_ids
        if kw < k:  # pad to the caller's k so batch shapes line up
            pad = int(k) - kw
            vals = np.concatenate(
                [vals, np.full((vals.shape[0], pad), np.inf,
                               dtype=vals.dtype)], axis=1)
            ids = np.concatenate(
                [ids, np.full((ids.shape[0], pad), -1, dtype=ids.dtype)],
                axis=1)
        pend = tenant.pending_view()
        if pend is not None:
            vals, ids = _merge_pending(_host(queries).astype(np.float32),
                                       vals, ids, int(k), warm.metric,
                                       *pend)
        tenant.record_degraded()
        if obs.enabled():
            obs.add("capacity.serves.degraded")
            obs.add(f"capacity.tenant.{tenant.name}.degraded")
        # the SERVING tier: a HOT tenant queued into its warm codes still
        # served from WARM — the result says what actually answered
        return TenantResult(vals, ids, tenant.name, WARM, degraded=True)

    def _hold_for_admit(self, predicted, entry: str, tenant: str) -> dict:
        """QUEUE with no warm fallback: hold under the caller's active
        Deadline, re-checking admission — expiry raises the classified
        DEADLINE (never a hang); with no deadline the hold is a bounded
        number of re-checks before the verdict goes final."""
        for _ in range(64):
            dl = resilience.active_deadline()
            if dl is None:
                break
            resilience.check_deadline()   # raises classified on expiry
            time.sleep(min(0.005, max(dl.remaining(), 0.0) or 0.001))
            rec = self.admit(predicted, entry=entry, tenant=tenant)
            if rec["verdict"] != costmodel.QUEUE:
                return rec
        resilience.check_deadline()
        return self.admit(predicted, entry=entry, tenant=tenant)

    def search(self, name: str, queries, k: int, n_probes: int = 20,
               **kw) -> TenantResult:
        """Serve one query batch against tenant ``name`` under the
        binding admission policy. HOT + ADMIT serves exact; QUEUE
        pressure (or a WARM/COLD tier) serves DEGRADED from the
        always-resident BQ codes with ``degraded=True`` stamped; a final
        REJECT raises :class:`CapacityRejected`. A COLD tenant first
        pages its warm codes back in (admission-checked)."""
        tenant = self.registry.get(name)
        self.registry.touch(name)
        t0 = time.monotonic()
        attrs = None
        if obs.enabled():
            attrs = {"tenant": name, "tier": tenant.tier}
            obs.add(f"capacity.tenant.{name}.serves")
        with obs.record_span("capacity::search", attrs=attrs):
            try:
                result = self._search_impl(tenant, queries, k, n_probes,
                                           **kw)
            except Exception as e:
                kind = resilience.classify(e)
                outcome = REJECTED if isinstance(e, CapacityRejected) \
                    else kind
                tenant.record_outcome(outcome)
                if outcome == REJECTED:
                    with self._lock:
                        self._counts["rejections"] += 1
                    if obs.enabled():
                        obs.add("capacity.rejections")
                record_event("capacity_serve_failed", tenant=name,
                             kind=kind, outcome=outcome,
                             error=repr(e)[:200])
                raise
            dt = time.monotonic() - t0
            tenant.record_serve(dt)
            if obs.enabled():
                obs.observe("capacity.serve_latency_s", dt)
                if result.degraded:
                    # the attribute the shadow/SLO plane keys the recall
                    # hit off: degraded serves are a separate series
                    obs.observe("capacity.degraded_latency_s", dt)
            return result

    def _search_impl(self, tenant: Tenant, queries, k, n_probes,
                     **kw) -> TenantResult:
        if tenant.tier == COLD and not tenant.warm_enabled:
            raise CapacityRejected(
                f"tenant {tenant.name!r} is COLD and has no warm tier — "
                f"promote it")
        if tenant.tier == COLD:
            # page the codes back in (small; admission-checked with
            # eviction allowed) — failure leaves the tenant COLD
            rec = self.admit(tenant.warm_bytes, entry="capacity.warm_load",
                             tenant=tenant.name)
            if rec["verdict"] == costmodel.REJECT:
                raise CapacityRejected(
                    f"tenant {tenant.name!r} is COLD and its warm codes "
                    f"({tenant.warm_bytes} B) do not fit the budget "
                    f"(projected {rec['projected_bytes']} of "
                    f"{rec['budget_bytes']} B)")
            self._load_warm(tenant)
        if tenant.tier == HOT and tenant.hot_obj is not None:
            q = int(queries.shape[0])
            try:
                est = costmodel.estimate_search(
                    tenant.hot_obj, q=q, k=int(k), n_probes=int(n_probes))
            except Exception as e:
                # an unpredictable family must not cost the dispatch:
                # admit with a zero estimate, classified
                record_event("capacity_estimate_error", tenant=tenant.name,
                             kind=resilience.classify(e),
                             error=repr(e)[:200])
                est = 0
            rec = self.admit(est, entry="capacity.search",
                             tenant=tenant.name)
            if rec["verdict"] != costmodel.ADMIT:
                # memory pressure on the exact dispatch: the graceful
                # path is the always-resident warm codes — a degraded
                # answer (stamped) instead of a refusal; eviction for a
                # REJECT already ran inside admit()
                if tenant.warm_index is not None:
                    with self._lock:
                        self._counts["queued_degraded"] += 1
                    if obs.enabled():
                        obs.add("capacity.queued_degraded")
                    return self._serve_warm(tenant, queries, k, n_probes)
                if rec["verdict"] == costmodel.QUEUE:
                    rec = self._hold_for_admit(est, "capacity.search",
                                               tenant.name)
            if rec["verdict"] == costmodel.REJECT:
                raise CapacityRejected(
                    f"dispatch for tenant {tenant.name!r} rejected: "
                    f"projected {rec['projected_bytes']} of "
                    f"{rec['budget_bytes']} B even after eviction")
            vals, ids = tenant.search_fn(tenant.hot_obj, queries, int(k),
                                         n_probes=int(n_probes), **kw)
            return TenantResult(vals, ids, tenant.name, HOT,
                                degraded=False)
        if tenant.warm_index is None:
            raise CapacityRejected(
                f"tenant {tenant.name!r} holds nothing resident at tier "
                f"{tenant.tier!r} and has no warm codes — promote it")
        return self._serve_warm(tenant, queries, k, n_probes)

    # -- reporting -----------------------------------------------------------
    def promote_latency(self) -> dict:
        with self._lock:
            lats = np.asarray(self._promote_lats, dtype=np.float64)
        out = {"count": int(lats.size)}
        if lats.size:
            out["p50_s"] = round(float(np.percentile(lats, 50)), 6)
            out["p99_s"] = round(float(np.percentile(lats, 99)), 6)
            out["max_s"] = round(float(lats.max()), 6)
        return out

    def report(self) -> dict:
        """The per-tenant capacity section ``obs.report.collect``
        embeds: budget + predicted residency, tier census, demotion/
        promotion/rejection counts, measured promote latency, and one
        SLO row per tenant (verdicts, outcomes, latency percentiles)."""
        resident = self.registry.resident_bytes()
        tiers = self.registry.tier_counts()
        with self._lock:
            counts = dict(self._counts)
        rows = {}
        for t in self.registry.tenants():
            rows[t.name] = {
                "tier": t.tier,
                "resident_bytes": int(t.resident_bytes()),
                "hot_bytes": int(t.hot_bytes),
                "warm_bytes": int(t.warm_bytes),
                "demotions": int(t.demotions),
                "promotions": int(t.promotions),
                "pending_rows": int(t.pending_rows),
                "verdicts": {k: int(v)
                             for k, v in sorted(t.verdicts.items())},
                "slo": t.slo_row(),
            }
        out = {
            "budget_bytes": int(self.budget_bytes),
            "budget_source": self.budget_source,
            "resident_bytes": int(resident),
            "resident_fraction": (round(resident / self.budget_bytes, 4)
                                  if self.budget_bytes else None),
            "tenants_resident_hot": tiers[HOT],
            "tenants_resident_warm": tiers[WARM],
            "tenants_cold": tiers[COLD],
            "promote": self.promote_latency(),
            **counts,
            "tenants": rows,
        }
        return out
