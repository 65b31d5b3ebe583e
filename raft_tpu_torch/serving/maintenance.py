"""Always-live index maintenance (counterpart of
``raft_tpu/serving/maintenance.py``): drift detection and online
re-clustering.

A paged store under sustained upserts decays in three distinct ways, and
until now only one of them had a background answer:

* **tombstones** — dead slots the scans DMA past; compaction
  (serving/compaction.py) already folds them out.
* **list skew** — a drifting data distribution overfills some lists: the
  padded scans pay the longest chain, and recall at fixed ``n_probes``
  drops because one probe no longer means one n-th of the corpus.
* **centroid staleness** — the coarse quantizer was trained on the
  corpus of round 0; recall decays *silently* as the corpus walks away
  from it. The shadow sampler (obs/shadow.py) can SEE this — its Wilson
  interval is the statistical band the live estimate should stay in —
  but nothing acted on it.

The :class:`MaintenanceManager` generalizes the compaction pattern into a
maintenance plane with three deadline-bounded, faultpointed phases:

1. **detect** (``serving.maintenance.detect``) — fold per-list fill skew
   (the store's incremental ``_list_live`` counters), tombstone ratio and
   the shadow sampler's recall trend into one ``drift_score`` (each
   component normalized by its own trigger threshold, so 1.0 means "some
   signal crossed its line"). Exported as the ``store.list_skew`` /
   ``store.drift_score`` gauges plus a classified ``drift_detected``
   event naming the dominant signal.
2. **recluster** (``serving.maintenance.recluster``) — split the hottest
   lists (deterministic 2-means, ivf_flat.split_list_rows) into their own
   slot plus a cold donor's, re-assign the donor's rows to their nearest
   new center, and re-encode ONLY the affected rows through the shared
   streamed-build fast path (``_prepare_payload`` → ``_encode_chunk`` /
   SRHT rotation; the clone's pools are written with ``index_copy`` on
   copies, never in place). IVF-RaBitQ's observation that coarse k-means is
   essentially the whole build cost is what makes this affordable: the
   incremental cycle touches a few lists' rows, never the corpus.
   When the raw vectors are gone (pq/bq payloads), rows come from the
   codes' own reconstruction (``reconstruct_rows``) unless the caller
   provides an exact ``row_source``.
3. **swap** (``serving.maintenance.swap``) — adopt the staged clone via
   :meth:`~raft_tpu_torch.serving.PagedListStore.recluster_swap`: the same
   mutation-version optimistic-concurrency as compaction (racing
   mutations abort classified-``stale``; in-flight searches keep their
   snapshots), and because the centers array keeps its shape and the
   clone keeps the pool capacity/table width, every compiled scan program
   keeps its operand shapes — maintenance never changes the scans'
   operand signatures.

``CompactionManager`` rides along as the tombstone policy: ``pump()``
drives it first, then measures drift, then re-clusters when the skew or
recall component is what crossed the line (tombstone-dominant drift IS
compaction's job). Failures classify into counters + the event ring; an
admission check (obs/costmodel) prices the staging clone — which
transiently doubles the store's resident footprint — before any work.

Drive it deterministically (:meth:`MaintenanceManager.pump` in serving
idle gaps — what the bench and tier-1 do) or with the background worker
(:meth:`start` / :meth:`stop`).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from raft_tpu_torch import obs, resilience
from raft_tpu_torch.resilience.retry import record_event
from raft_tpu_torch.serving.compaction import CompactionManager, _env_float
from raft_tpu_torch.serving.store import PagedListStore, _pow2_at_least

MAINT_DRIFT_ENV = "RAFT_TPU_MAINT_DRIFT_THRESHOLD"
MAINT_SKEW_ENV = "RAFT_TPU_MAINT_SPLIT_SKEW"
MAINT_DEADLINE_ENV = "RAFT_TPU_MAINT_DEADLINE_S"
MAINT_INTERVAL_ENV = "RAFT_TPU_MAINT_INTERVAL_S"
MAINT_PAIRS_ENV = "RAFT_TPU_MAINT_MAX_PAIRS"

_DEFAULT_DRIFT = 1.0
_DEFAULT_SKEW = 4.0
_DEFAULT_DEADLINE_S = 30.0
_DEFAULT_INTERVAL_S = 0.5
_DEFAULT_PAIRS = 4
# the tombstone component's normalizer when running without a compaction
# policy: the same default trigger a CompactionManager would have used
_DEFAULT_RATIO_FALLBACK = 0.25


def default_drift_threshold() -> float:
    """Drift score at which a cycle is warranted
    (``RAFT_TPU_MAINT_DRIFT_THRESHOLD``, default 1.0 — the score is
    pre-normalized so 1.0 means "a signal crossed its own trigger")."""
    return _env_float(MAINT_DRIFT_ENV, _DEFAULT_DRIFT)


def default_split_skew() -> float:
    """Per-list fill multiple of the mean above which a list is split
    (``RAFT_TPU_MAINT_SPLIT_SKEW``, default 4.0 — the packed layout's
    auto-list-cap allowance, so a split fires about when the packed
    build would have spilled)."""
    return _env_float(MAINT_SKEW_ENV, _DEFAULT_SKEW)


def default_maintenance_deadline() -> float:
    """Per-phase wall-clock bound in seconds
    (``RAFT_TPU_MAINT_DEADLINE_S``, default 30)."""
    return _env_float(MAINT_DEADLINE_ENV, _DEFAULT_DEADLINE_S)


def default_maintenance_interval() -> float:
    """Background worker poll interval in seconds
    (``RAFT_TPU_MAINT_INTERVAL_S``, default 0.5)."""
    return _env_float(MAINT_INTERVAL_ENV, _DEFAULT_INTERVAL_S)


def default_max_pairs() -> int:
    """Hot/cold list pairs re-clustered per cycle
    (``RAFT_TPU_MAINT_MAX_PAIRS``, default 4 — incremental by design:
    many small cycles beat one rebuild-sized one)."""
    return max(1, int(_env_float(MAINT_PAIRS_ENV, _DEFAULT_PAIRS)))


class MaintenanceManager:
    """Drift-triggered background maintenance manager for one paged store.

    ``sampler`` (optional :class:`~raft_tpu_torch.obs.shadow.ShadowSampler`)
    supplies the recall trend; ``compaction`` the tombstone policy (a
    default :class:`CompactionManager` is built when omitted; pass None
    explicitly to run without one). ``row_source(ids) -> (n, dim)
    float32`` overrides the code-reconstruction row source for pq/bq
    stores when the caller kept the raw vectors.

    Thread-safe like the compaction manager: counters live under their
    own leaf ``_stats_lock`` (never held across store calls), one cycle
    at a time serializes on ``_busy``.
    """

    def __init__(self, store: PagedListStore, *, sampler=None,
                 compaction="auto",
                 row_source: Optional[Callable] = None,
                 drift_threshold: Optional[float] = None,
                 split_skew: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 interval_s: Optional[float] = None,
                 max_pairs: Optional[int] = None,
                 min_split_rows: int = 8):
        if not isinstance(store, PagedListStore):
            raise TypeError(
                "MaintenanceManager maintains a PagedListStore; got "
                f"{type(store).__name__} (packed indexes are immutable — "
                "wrap with PagedListStore.from_index first)")
        self.store = store
        self.sampler = sampler
        self.compaction = (CompactionManager(store)
                           if compaction == "auto" else compaction)
        self.row_source = row_source
        self.drift_threshold = float(
            drift_threshold if drift_threshold is not None
            else default_drift_threshold())
        self.split_skew = max(1.001, float(
            split_skew if split_skew is not None else default_split_skew()))
        self.deadline_s = float(deadline_s if deadline_s is not None
                                else default_maintenance_deadline())
        self.interval_s = float(interval_s if interval_s is not None
                                else default_maintenance_interval())
        self.max_pairs = int(max_pairs if max_pairs is not None
                             else default_max_pairs())
        self.min_split_rows = max(4, int(min_split_rows))
        # counter plane: mutated by whichever thread wins _busy, read by
        # stats()/report() from serving threads — its own leaf lock,
        # never held across store or sampler calls
        self._stats_lock = threading.Lock()
        self.cycles = 0         # guarded-by: _stats_lock, reads-ok
        self.stale_aborts = 0   # guarded-by: _stats_lock, reads-ok
        self.failures = 0       # guarded-by: _stats_lock, reads-ok
        self.skipped = 0        # guarded-by: _stats_lock, reads-ok -- denied/noop-degenerate cycles
        self.drift_events = 0   # guarded-by: _stats_lock, reads-ok
        self.pairs_total = 0    # guarded-by: _stats_lock, reads-ok
        self.rows_moved = 0     # guarded-by: _stats_lock, reads-ok
        self.drift_score = 0.0  # guarded-by: _stats_lock, reads-ok
        self.list_skew = 0.0    # guarded-by: _stats_lock, reads-ok
        self.last_status: Optional[str] = None  # guarded-by: _stats_lock, reads-ok
        self.last_duration_s: Optional[float] = None  # guarded-by: _stats_lock, reads-ok
        # first healthy shadow estimate: the (recall, ci_low) band every
        # later estimate is judged against
        self._recall_base: Optional[tuple] = None  # guarded-by: _stats_lock, reads-ok
        self._recall_last: Optional[float] = None  # guarded-by: _stats_lock, reads-ok
        self._busy = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        self._stopping = False

    # -- drift detection ----------------------------------------------------
    def _recall_component(self) -> tuple:
        """``(excess, estimate)`` — recall decay measured in units of the
        BASELINE Wilson half-width: >= 1.0 means the live estimate fell
        out of the CI band the first healthy window established. 0.0
        while the sampler is absent, stale, or still establishing."""
        if self.sampler is None:
            return 0.0, None
        est = self.sampler.estimate()
        if est["recall"] is None or est["stale"]:
            return 0.0, est
        with self._stats_lock:
            if self._recall_base is None and est["samples"] >= 8:
                self._recall_base = (est["recall"], est["ci_low"])
            base = self._recall_base
            self._recall_last = est["recall"]
        if base is None:
            return 0.0, est
        half = max(base[0] - base[1], 1e-6)
        return max(0.0, (base[0] - est["recall"]) / half), est

    def detect(self) -> dict:
        """One drift measurement: skew, tombstone and recall components
        (each normalized by its own trigger), folded as their max into
        ``drift_score`` and exported as gauges. Crossing
        ``drift_threshold`` files a classified ``drift_detected`` event
        naming the dominant signal. Deadline-bounded and faultpointed
        (``serving.maintenance.detect``) like every maintenance phase."""
        with obs.record_span("serving::maintenance_detect"):
            with resilience.Deadline(self.deadline_s,
                                     label="serving.maintenance.detect"):
                resilience.faultpoint("serving.maintenance.detect")
                skew = self.store.list_skew()
                tomb = float(self.store.tombstone_ratio)
                recall_x, est = self._recall_component()
        comp_ratio = (self.compaction.ratio if self.compaction is not None
                      else _DEFAULT_RATIO_FALLBACK)
        components = {
            "skew": skew / self.split_skew,
            "tombstones": tomb / max(comp_ratio, 1e-9),
            "recall": recall_x,
        }
        score = max(components.values())
        dominant = max(components, key=components.get)
        drifted = score >= self.drift_threshold
        with self._stats_lock:
            self.drift_score = score
            self.list_skew = skew
            if drifted:
                self.drift_events += 1
        if obs.enabled():
            obs.set_gauge("store.list_skew", skew)
            obs.set_gauge("store.drift_score", score)
        if drifted:
            obs.add("serving.maintenance.drift_detected")
            record_event("drift_detected", signal=dominant,
                         drift_score=round(score, 4),
                         list_skew=round(skew, 4),
                         tombstone_ratio=round(tomb, 4),
                         recall_component=round(recall_x, 4))
        return {"drift_score": score, "list_skew": skew,
                "tombstone_ratio": tomb, "components": components,
                "dominant": dominant, "drifted": drifted,
                "recall_estimate": None if est is None else est["recall"]}

    # -- re-clustering ------------------------------------------------------
    def _plan_pairs(self, counts: np.ndarray) -> list:
        """(hot, cold) list pairs for this cycle: the hottest lists above
        ``split_skew``× the mean fill, paired hottest-first with the
        emptiest donors below the mean. Hot and cold sets are disjoint by
        construction (split_skew > 1), capped at ``max_pairs``."""
        total = int(counts.sum())
        n = counts.shape[0]
        if total == 0 or n < 2:
            return []
        mean = total / n
        order = np.argsort(counts, kind="stable")
        hots = [int(l) for l in order[::-1]
                if counts[l] > self.split_skew * mean
                and counts[l] >= self.min_split_rows]
        colds = [int(l) for l in order if counts[l] < mean]
        return list(zip(hots, colds))[:self.max_pairs]

    def _rows_for(self, payload, extra, ids_np, labels_np,
                  idx) -> torch.Tensor:
        """Assignment-grade float32 vectors for the selected live rows:
        the raw payload for flat stores, the caller's ``row_source`` when
        provided, else the codes' own reconstruction (exact codeword /
        RaBitQ projection, un-rotated — neighbors ``reconstruct_rows``).
        Reconstruction uses the CURRENT centers and OLD labels: the codes
        were encoded against them."""
        store = self.store
        dev = store.device
        idx_t = torch.from_numpy(np.asarray(idx, np.int64)).to(dev)
        if self.row_source is not None:
            rows = torch.from_numpy(np.ascontiguousarray(
                self.row_source(np.asarray(ids_np)[idx]),
                dtype=np.float32)).to(dev)
        elif store.kind == "ivf_flat":
            rows = payload[idx_t].to(torch.float32)
        elif store.kind == "ivf_pq":
            from raft_tpu_torch.neighbors import ivf_pq as ivf_pq_mod

            rows = ivf_pq_mod.reconstruct_rows(
                store.centers, store.rotation, store.codebooks,
                payload[idx_t],
                torch.from_numpy(np.asarray(labels_np)[idx]).to(dev),
                store.pq_dim, store.pq_bits, store.dim)
        else:
            from raft_tpu_torch.neighbors import ivf_bq as ivf_bq_mod

            rows = ivf_bq_mod.reconstruct_rows(
                store.centers, store.rotation, payload[idx_t], extra[idx_t],
                torch.from_numpy(np.asarray(labels_np)[idx]).to(dev),
                store.bq_bits, store.rotation_kind, store.dim)
        if store.metric == "cosine":
            rows = rows / torch.clamp(torch.linalg.vector_norm(
                rows, dim=1, keepdim=True), min=1e-30)
        return rows

    def _admission_denied(self, pairs: int) -> bool:
        """Price the staging clone (it transiently doubles the store's
        resident pools) through the costmodel admission gate; REJECT skips
        the cycle classified-``denied``. The check itself never raises
        (check_admission's contract) — a broken layout probe degrades to
        an admit, classified there."""
        from raft_tpu_torch.obs import costmodel

        layout = costmodel.index_layout(self.store)
        predicted = costmodel.predict_index_bytes(**layout)
        verdict = costmodel.check_admission(
            predicted, entry="serving.maintenance.recluster")
        if verdict.get("verdict") != costmodel.REJECT:
            return False
        obs.add("serving.maintenance.denied")
        record_event("maintenance_denied", pairs=pairs,
                     predicted_bytes=int(predicted))
        return True

    def _stage_clone(self, pairs: list):
        """Build the staging clone for this cycle's split/merge plan:
        relabel, re-encode ONLY the affected rows, ingest every surviving
        row in snapshot order. Returns ``(clone, n_pairs, n_moved)`` or
        None when the plan degenerates (nothing split)."""
        store = self.store
        payload, aux, extra, ids_np, labels_np = store._live_rows()
        n = int(ids_np.shape[0])
        if n == 0:
            return None
        labels_new = labels_np.astype(np.int32).copy()
        centers_new = store.centers.cpu().numpy().astype(np.float32,
                                                          copy=True)
        split_lists: list = []
        for h, c in pairs:
            h_idx = np.nonzero(labels_np == h)[0]
            if h_idx.size < self.min_split_rows:
                continue
            from raft_tpu_torch.neighbors import ivf_flat as ivf_flat_mod

            rows_h = self._rows_for(payload, extra, ids_np, labels_np,
                                    h_idx).cpu().numpy()
            c2, assign = ivf_flat_mod.split_list_rows(rows_h)
            if assign.min() == assign.max():
                continue  # degenerate (identical rows): leave the list be
            centers_new[h] = c2[0]
            centers_new[c] = c2[1]
            labels_new[h_idx] = np.where(assign == 0, h, c).astype(np.int32)
            split_lists.append((h, c))
        if not split_lists:
            return None
        # donor rows: their center was replaced by the split's second
        # half — re-home each to its nearest NEW center (full centers
        # array, one small host matmul per cycle)
        donor_idx = np.nonzero(np.isin(
            labels_np, [c for _, c in split_lists]))[0]
        if donor_idx.size:
            rows_d = self._rows_for(
                payload, extra, ids_np, labels_np, donor_idx).cpu().numpy()
            if store.metric in ("cosine", "inner_product"):
                labels_new[donor_idx] = np.argmax(
                    rows_d @ centers_new.T, axis=1).astype(np.int32)
            else:
                d2 = ((rows_d ** 2).sum(1, keepdims=True)
                      - 2.0 * rows_d @ centers_new.T
                      + (centers_new ** 2).sum(1)[None, :])
                labels_new[donor_idx] = np.argmin(d2, axis=1).astype(np.int32)
        moved = np.nonzero(labels_new != labels_np)[0]
        # every row whose NEW home is a split slot sits on a moved center
        # even if its label survived — pq/bq encodings reference the
        # center, so those rows re-encode too
        touched_lists = np.array(sorted(
            {l for hc in split_lists for l in hc}), np.int32)
        affected = np.union1d(moved, np.nonzero(
            np.isin(labels_new, touched_lists))[0])
        clone = store._empty_clone(centers=torch.from_numpy(centers_new))
        if store.kind == "ivf_flat" or affected.size == 0:
            payload_new, aux_new, extra_new = payload, aux, extra
        else:
            # pow2-bucketed re-encode (repeat-pad, slice back): the
            # encode sees the same ladder of row counts as the JAX one
            n_aff = int(affected.size)
            bucket = _pow2_at_least(n_aff)
            sel = np.concatenate(
                [affected, np.repeat(affected[:1], bucket - n_aff)])
            work = self._rows_for(payload, extra, ids_np, labels_np, sel)
            p_b, a_b, _, e_b = clone._prepare_payload(work, labels_new[sel])
            idx_dev = torch.from_numpy(affected.astype(np.int64)).to(
                store.device)
            # index_copy returns a copy: the snapshot's tensors stay as
            # they were for any search still holding them
            payload_new = payload.index_copy(0, idx_dev, p_b[:n_aff])
            aux_new = aux.index_copy(0, idx_dev, a_b[:n_aff])
            extra_new = (None if extra is None
                         else extra.index_copy(0, idx_dev, e_b[:n_aff]))
        labels_dev = torch.from_numpy(labels_new.astype(np.int64)).to(
            store.device)
        if store.kind == "ivf_pq":
            from raft_tpu_torch.neighbors import ivf_pq as ivf_pq_mod

            # the decoded int8 cache is a deterministic function of the
            # codes (bitwise-stable across recomputes), and _live_rows
            # does not carry it — rebuild it whole for the clone
            extra_new = ivf_pq_mod._decode_code_rows(
                store.codebooks, payload_new, store.decoded_scale,
                store.pq_dim, store.pq_bits)
            if store.metric in ("sqeuclidean", "euclidean"):
                rc2 = ivf_pq_mod._center_rot_sqnorm(clone.centers,
                                                    store.rotation)
                bias_new = rc2[labels_dev] + aux_new
            else:
                bias_new = aux_new
        else:
            # flat: norms/zeros; bq: aux IS the scan bias at live rows
            bias_new = aux_new
        with clone._lock:
            clone._ingest_rows(payload_new, ids_np, aux_new, labels_new,
                               bias_new, extra_new)
        if obs.enabled():
            from raft_tpu_torch.obs import roofline as obs_roofline

            rot_dim = (0 if store.rotation is None
                       else int(store.rotation.shape[-1]))
            obs_roofline.note_dispatch(
                "serving.maintenance.reencode",
                {"n_rows": int(affected.size), "dim": store.dim,
                 "rot_dim": 0 if store.kind == "ivf_flat" else rot_dim,
                 "pq_dim": store.pq_dim if store.kind == "ivf_pq" else 0,
                 "n_codes": (int(store.codebooks.shape[1])
                             if store.kind == "ivf_pq" else 0)})
        return clone, len(split_lists), int(moved.size)

    def recluster(self) -> dict:
        """One incremental re-clustering cycle: plan hot/cold pairs from
        the live fill counts, stage a same-shape clone off the hot path
        (``serving.maintenance.recluster``), swap it in atomically
        (``serving.maintenance.swap``). Every outcome is classified:
        ``ok`` / ``noop`` / ``denied`` / ``stale`` / an exception kind."""
        store = self.store
        t0 = time.perf_counter()
        v0 = store.mutation_version
        try:
            with obs.record_span("serving::maintenance_recluster"):
                with resilience.Deadline(
                        self.deadline_s,
                        label="serving.maintenance.recluster"):
                    # faultpoint INSIDE the deadline scope: an armed hang
                    # spins on check_interrupt bounded by deadline_s
                    resilience.faultpoint("serving.maintenance.recluster")
                    pairs = self._plan_pairs(store.list_fill_counts())
                    if not pairs:
                        staged = None
                    elif self._admission_denied(len(pairs)):
                        return self._finish("denied", t0, 0, 0)
                    else:
                        staged = self._stage_clone(pairs)
            if staged is None:
                return self._finish("noop", t0, 0, 0)
            clone, n_pairs, n_moved = staged
            with obs.record_span("serving::maintenance_swap"):
                with resilience.Deadline(self.deadline_s,
                                         label="serving.maintenance.swap"):
                    resilience.faultpoint("serving.maintenance.swap")
                    swapped = store.recluster_swap(clone, v0)
        except Exception as e:
            kind = resilience.classify(e)
            with self._stats_lock:
                self.failures += 1
                self.last_status = kind
                self.last_duration_s = time.perf_counter() - t0
            obs.add(f"serving.maintenance.{kind.lower()}")
            record_event("maintenance_error", kind=kind, version=v0,
                         error=repr(e)[:200])
            return {"status": kind, "duration_s": self.last_duration_s}
        if not swapped:
            # a mutation landed between the snapshot and the swap: the
            # staged work is discarded, nothing changed, the next pump
            # retries against the new version — classified, never silent
            out = self._finish("stale", t0, n_pairs, 0)
            record_event("maintenance_stale", version=v0, pairs=n_pairs)
            return out
        out = self._finish("ok", t0, n_pairs, n_moved)
        record_event("maintenance_recluster", pairs=n_pairs,
                     rows_moved=n_moved, version=v0,
                     skew_after=round(store.list_skew(), 4))
        return out

    def _finish(self, status: str, t0: float, n_pairs: int,
                n_moved: int) -> dict:
        dt = time.perf_counter() - t0
        with self._stats_lock:
            self.last_status = status
            self.last_duration_s = dt
            if status == "ok":
                self.cycles += 1
                self.pairs_total += n_pairs
                self.rows_moved += n_moved
            elif status == "stale":
                self.stale_aborts += 1
            else:
                self.skipped += 1
        obs.add(f"serving.maintenance.{status}")
        if status == "ok" and obs.enabled():
            obs.observe("serving.maintenance.duration_s", dt)
        return {"status": status, "pairs": n_pairs, "rows_moved": n_moved,
                "duration_s": dt}

    # -- scheduling ---------------------------------------------------------
    def pump(self) -> Optional[dict]:
        """One scheduler step: compaction policy first (its own ratio
        trigger), then a drift measurement, then — when the skew or
        recall component is what crossed the threshold — one
        re-clustering cycle. Returns the step's record, or None when a
        concurrent pump held ``_busy``. The deterministic entry for
        serving loops and tier-1."""
        if not self._busy.acquire(blocking=False):
            return None
        try:
            compact_out = (self.compaction.pump()
                           if self.compaction is not None else None)
            try:
                sig = self.detect()
            except Exception as e:
                kind = resilience.classify(e)
                with self._stats_lock:
                    self.failures += 1
                    self.last_status = kind
                obs.add(f"serving.maintenance.{kind.lower()}")
                record_event("maintenance_error", kind=kind, phase="detect",
                             error=repr(e)[:200])
                return {"status": kind, "phase": "detect",
                        "compaction": compact_out}
            recluster_out = None
            if sig["drifted"] and sig["dominant"] != "tombstones":
                recluster_out = self.recluster()
            return {"status": (recluster_out or {}).get("status", "idle"),
                    "drift": sig, "recluster": recluster_out,
                    "compaction": compact_out}
        finally:
            self._busy.release()

    # -- worker -------------------------------------------------------------
    def start(self) -> None:
        """Run the maintenance loop on a daemon worker thread — drift
        response truly off the serving thread (pump-in-idle-gaps stays
        available for deterministic runs)."""
        if self._worker is not None and self._worker.is_alive():
            return
        self._stopping = False
        self._worker = threading.Thread(
            target=self._run_loop, name="raft-tpu-torch-maintenance",
            daemon=True)
        self._worker.start()

    def _run_loop(self) -> None:
        while not self._stopping:
            self.pump()
            time.sleep(self.interval_s)

    def stop(self, timeout: float = 30.0) -> None:
        self._stopping = True
        if self._worker is not None:
            self._worker.join(timeout=timeout)
            self._worker = None

    # -- reporting ----------------------------------------------------------
    def report(self) -> dict:
        """The obs report's ``maintenance`` section (and ``stats()``
        alias): drift state, cycle counters, and the recall trend the
        drift detector is holding the store to."""
        comp = (self.compaction.stats()
                if self.compaction is not None else None)
        skew_now = self.store.list_skew()  # store call OUTSIDE the lock
        with self._stats_lock:
            base = self._recall_base
            recall = {
                "baseline": None if base is None else round(base[0], 4),
                "baseline_ci_low": None if base is None else round(base[1], 4),
                "estimate": (None if self._recall_last is None
                             else round(self._recall_last, 4)),
                "decay": (None if base is None or self._recall_last is None
                          else round(base[0] - self._recall_last, 4)),
            }
            return {
                "drift_score": round(self.drift_score, 4),
                "list_skew": round(skew_now, 4),
                "cycles": self.cycles,
                "stale_aborts": self.stale_aborts,
                "failures": self.failures,
                "skipped": self.skipped,
                "drift_events": self.drift_events,
                "pairs_total": self.pairs_total,
                "rows_moved": self.rows_moved,
                "last_status": self.last_status,
                "last_duration_s": self.last_duration_s,
                "recall": recall,
                "drift_threshold": self.drift_threshold,
                "split_skew": self.split_skew,
                "compaction": comp,
            }

    stats = report

