"""SLO-aware dynamic query batching (counterpart of
``raft_tpu/serving/batching.py``): one-at-a-time in, card batches out.

Queries arrive one at a time; the card's throughput comes from batches.
The :class:`QueryQueue` coalesces single requests with per-request
deadlines (:class:`raft_tpu_torch.resilience.Deadline`) into batches whose
size is chosen under a latency SLO, dispatches them through a search entry
point, and hands each request its row of the batched result.

Admission — **admit until deadline pressure**: a forming batch keeps
taking queued requests while the tightest pending deadline still leaves
room for one more dispatch (a per-bucket EWMA of measured batch latency).
It dispatches when the pool reaches the batch cap, when the tightest
deadline's slack falls below the estimate plus a margin, or when the
oldest request has waited ``fill_wait_s``.

Batch sizes come from a power-of-two **bucket ladder** (1, 2, 4, …,
``max_batch``), padded with copies of the first query: eager PyTorch has no
compile to amortise, but the ladder fixes which batch sizes the kernels
are planned and launched at, and each bucket keeps its own latency EWMA.

Failures: the dispatch carries the ``serving.queue.dispatch``
faultpoint; an expired request gets a classified DEADLINE verdict; an
OOM-classified dispatch **halves the batch cap** and requeues; a
TRANSIENT one retries once; a FATAL error goes, classified, to exactly
the requests of that batch while the queue keeps serving. Requeued
survivors are counted once (``serving.queue.requeued``). No failure runs
a plain twin or the CPU in place of the failed call.

**Materialization.** The batch's result is copied to the host
(``.cpu().numpy()``) inside the deadline scope: the copy is what waits for
the card's kernels, so a result is served only once it exists. The worker
thread and :meth:`QueryQueue.pump` both dispatch on the default CUDA
stream.

**Pre-dispatch admission**: with a ``cost_model`` hook
(``obs.costmodel.paged_scan_estimator(store, k, n_probes)``) every batch
first runs ``costmodel.check_admission``, and the ADMIT / QUEUE / REJECT
verdict lands as gauges, events and a span attribute. With a
``capacity=`` controller (:class:`raft_tpu_torch.serving.CapacityController`)
the verdict acts: QUEUE holds the batch (requeued at the front, re-checked
after a short backoff; expired requests still drain), REJECT delivers the
classified ``rejected`` verdict to that batch. Each dispatch runs under
``obs.compile.watch()``.

**Per-request traces**: with telemetry on, each request gets a
``serving::request`` root with ``submit → admit → dispatch → complete``
children recorded through ``obs.tracing.manual_span`` (the lifecycle
crosses the caller's thread and the batcher's). With telemetry off the hot
path pays one branch and allocates no ids.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from raft_tpu_torch import obs, resilience
from raft_tpu_torch.obs import compile as obs_compile
from raft_tpu_torch.resilience.deadline import DeadlineExceeded
from raft_tpu_torch.resilience.retry import record_event

_OK = "ok"


class _Request:
    __slots__ = ("query", "t_arrive", "t_deadline", "event", "vals", "ids",
                 "verdict", "error", "retries", "requeued", "_latency_s",
                 "trace_id", "span_id", "t_epoch", "t_admit")

    def __init__(self, query: np.ndarray, t_arrive: float, t_deadline: float):
        self.query = query
        self.t_arrive = t_arrive
        self.t_deadline = t_deadline
        self.event = threading.Event()
        self.vals = None
        self.ids = None
        self.verdict: Optional[str] = None  # "ok" | resilience kind
        self.error: Optional[BaseException] = None
        self.retries = 0
        self.requeued = False
        # trace identity: allocated at submit ONLY under obs.enabled() —
        # the telemetry-off hot path must not pay id allocation
        self.trace_id: Optional[str] = None
        self.span_id: Optional[str] = None
        self.t_epoch = 0.0   # epoch twin of t_arrive (span t0 convention)
        self.t_admit = 0.0   # monotonic admit time (queue_wait_s source)


class RequestHandle:
    """Caller-side view of one submitted query."""

    def __init__(self, req: _Request):
        self._req = req

    def done(self) -> bool:
        return self._req.event.is_set()

    @property
    def verdict(self) -> Optional[str]:
        """``"ok"``, a :mod:`raft_tpu_torch.resilience` failure kind, or None
        while pending."""
        return self._req.verdict

    @property
    def trace_id(self) -> Optional[str]:
        """This request's trace id (the ``serving::request`` span tree in
        ``obs.tracing``); None when telemetry was off at submit."""
        return self._req.trace_id

    @property
    def latency_s(self) -> Optional[float]:
        return getattr(self._req, "_latency_s", None)

    def result(self, timeout: Optional[float] = None):
        """Block for the per-request ``(distances, indices)`` rows.
        Raises :class:`~raft_tpu_torch.resilience.DeadlineExceeded` on a
        DEADLINE verdict and the classified original error otherwise."""
        if not self._req.event.wait(timeout):
            raise TimeoutError("request still pending")
        if self._req.verdict == _OK:
            return self._req.vals, self._req.ids
        if self._req.verdict == resilience.DEADLINE:
            raise self._req.error or DeadlineExceeded(
                "DEADLINE_EXCEEDED: request expired in queue")
        raise self._req.error


def _host(x) -> np.ndarray:
    """A result tensor as a host array: the copy waits for the card."""
    if hasattr(x, "cpu"):
        return x.cpu().numpy()
    return np.asarray(x)


def _buckets(max_batch: int) -> List[int]:
    out = [1]
    while out[-1] < max_batch:
        out.append(min(out[-1] * 2, max_batch))
    return out


class QueryQueue:
    """Host-side request queue + dynamic batcher over one search callable.

    ``search_fn(queries_2d) -> (distances, indices)`` is any existing
    search entry point closed over its index/store and parameters —
    :func:`raft_tpu_torch.serving.searcher` builds the paged-store one.

    Drive it either with the background worker (:meth:`start` /
    :meth:`stop`) or synchronously (:meth:`pump` in a caller loop — what
    the bench's arrival simulator and the deterministic tier-1 tests do).
    """

    def __init__(self, search_fn: Callable, *,
                 slo_s: float = 0.05,
                 max_batch: int = 64,
                 fill_wait_s: Optional[float] = None,
                 default_timeout_s: Optional[float] = None,
                 pressure_margin_s: float = 0.002,
                 shadow=None,
                 cost_model: Optional[Callable] = None,
                 capacity=None, tenant: str = ""):
        self._search_fn = search_fn
        # optional online-recall shadow sampler (obs/shadow.ShadowSampler):
        # served results are OFFERED after each successful dispatch — one
        # seeded-hash decision per request, drop-on-pressure, never blocking
        self._shadow = shadow
        # optional pre-dispatch cost hook: ``batch_size -> bytes
        # or obs.costmodel.estimate dict``; each dispatch is first run
        # through ``costmodel.check_admission`` and the ADMIT/QUEUE/REJECT
        # verdict lands as gauges + classified events and on the dispatch
        # span. Observability only — a non-admit verdict does NOT block the
        # dispatch here; acting on it is the ROADMAP item-4 admission
        # controller, which consumes exactly these records.
        # (``costmodel.paged_scan_estimator(store, k, n_probes)`` builds
        # the hook for a paged store.)
        self._cost_model = cost_model
        # with a CapacityController the verdict ACTS (see the
        # module docstring) — QUEUE holds the batch, REJECT delivers the
        # classified ``rejected`` verdict after the controller's eviction
        # attempt. ``_hold_until`` is the QUEUE-hold backoff: the pump
        # loop stops re-popping a held batch every iteration while
        # deadline expiry keeps draining underneath it.
        self._capacity = capacity
        # the tenant this queue serves (optional): the controller's
        # eviction never demotes the tenant whose dispatch it is sizing,
        # and the verdict lands in that tenant's per-tenant counts
        self._tenant = str(tenant)
        self._hold_until = 0.0  # guarded-by: _cv
        self.slo_s = float(slo_s)
        self.max_batch = int(max_batch)
        self.buckets = _buckets(self.max_batch)
        self.fill_wait_s = (float(fill_wait_s) if fill_wait_s is not None
                            else self.slo_s / 2.0)
        self.default_timeout_s = default_timeout_s
        self.pressure_margin_s = float(pressure_margin_s)
        self._pending: deque = deque()  # guarded-by: _cv
        self._cv = threading.Condition()
        self._lat_ewma: Dict[int, float] = {}  # guarded-by: _cv -- bucket -> s
        self._batch_cap = self.max_batch  # guarded-by: _cv, reads-ok -- halved on OOM
        self._worker: Optional[threading.Thread] = None
        self._stopping = False  # guarded-by: _cv, reads-ok
        self.batches = 0        # guarded-by: _cv, reads-ok
        self.multi_batches = 0  # guarded-by: _cv, reads-ok

    # -- intake -------------------------------------------------------------
    def submit(self, query, timeout_s: Optional[float] = None) -> RequestHandle:
        """Enqueue one query; returns immediately with a handle. The
        request's deadline is ``now + timeout_s`` (or the queue default;
        no deadline when both are None)."""
        q = np.asarray(query, np.float32).reshape(-1)
        now = time.monotonic()
        t = timeout_s if timeout_s is not None else self.default_timeout_s
        req = _Request(q, now, now + t if t is not None else math.inf)
        enabled = obs.enabled()
        if enabled:
            # request trace root ids, allocated BEFORE the request is
            # published: the background worker may dequeue, dispatch and
            # close the request the instant it lands in the deque, and its
            # lifecycle spans must see fully-initialized identity
            tracing = obs.tracing
            req.trace_id = tracing.alloc_id()
            req.span_id = tracing.alloc_id()
            req.t_epoch = time.time()
        with self._cv:
            self._pending.append(req)
            depth = len(self._pending)
            self._cv.notify()
        if enabled:
            # ONE submit record per request (the explicit-lineage child of
            # the request root) + the flat timer series; a second
            # contextvar span here would double every submit in the ring
            dur = time.monotonic() - now
            obs.record_timing("serving::submit", dur)
            tracing.manual_span(
                "serving::submit", t0=req.t_epoch, dur_s=dur,
                trace_id=req.trace_id, parent_id=req.span_id,
                attrs={"depth": depth})
            obs.add("serving.queue.submits")
            obs.observe("serving.queue.depth", depth)
        return RequestHandle(req)

    # -- policy -------------------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _est_latency(self, bucket: int) -> Optional[float]:
        if bucket in self._lat_ewma:
            return self._lat_ewma[bucket]
        known = [v for b, v in self._lat_ewma.items() if b <= bucket]
        return max(known) if known else None

    def _expire_locked(self, now: float) -> List[_Request]:
        """Pop requests that are already past deadline (partial drain)."""
        expired = []
        keep = deque()
        for req in self._pending:
            (expired if req.t_deadline <= now else keep).append(req)
        self._pending = keep
        return expired

    def _ready_locked(self, now: float) -> bool:
        depth = len(self._pending)
        if depth == 0:
            return False
        if now < self._hold_until:
            # capacity QUEUE hold: admission said wait — expired requests
            # still drain (pump expires before it forms batches), so the
            # hold can never become a hang
            return False
        cap = max(1, self._batch_cap)
        if depth >= cap:
            return True
        oldest = min(r.t_arrive for r in self._pending)
        if now - oldest >= self.fill_wait_s:
            return True
        est = self._est_latency(self._bucket_for(min(depth, cap)))
        if est is None:
            # nothing measured yet: assume a dispatch costs a fraction of
            # the SLO (eagerly dispatching instead would burn the warmup
            # window on batch-1 programs)
            est = self.slo_s / 4.0
        tightest = min(r.t_deadline for r in self._pending)
        if tightest - now <= est + self.pressure_margin_s:
            return True  # deadline pressure: admit no further, go now
        return False

    # -- dispatch -----------------------------------------------------------
    def pump(self, now: Optional[float] = None) -> bool:
        """One scheduler step: drain expired requests, and dispatch one
        batch if the admission policy says go. Returns True when it did
        either (the caller loop's idle signal)."""
        now = time.monotonic() if now is None else now
        with self._cv:
            expired = self._expire_locked(now)
            batch: List[_Request] = []
            if self._ready_locked(now):
                cap = max(1, self._batch_cap)
                while self._pending and len(batch) < cap:
                    batch.append(self._pending.popleft())
        if batch and obs.enabled():
            t_admit = time.monotonic()
            for req in batch:
                req.t_admit = t_admit
        for req in expired:
            self._finish_deadline(req, "expired in queue")
        if batch:
            self._dispatch(batch)
        return bool(expired or batch)

    def _close_request_trace(self, req: _Request, verdict: str) -> None:
        """Record the request's ``serving::complete`` child and close its
        ``serving::request`` root span (error-tagged for non-ok verdicts).
        No-op for requests submitted with telemetry off — or finished
        after it was switched off (a cleared ring must stay clean)."""
        if req.trace_id is None or not obs.enabled():
            return
        done_epoch = time.time()
        obs.tracing.manual_span(
            "serving::complete", t0=done_epoch, dur_s=0.0,
            trace_id=req.trace_id, parent_id=req.span_id,
            attrs={"verdict": verdict})
        obs.tracing.manual_span(
            "serving::request", t0=req.t_epoch, dur_s=req._latency_s,
            trace_id=req.trace_id, span_id=req.span_id,
            attrs={"verdict": verdict, "requeued": req.requeued},
            error=None if verdict == _OK else verdict)

    def _finish_deadline(self, req: _Request, why: str) -> None:
        req.verdict = resilience.DEADLINE
        req.error = DeadlineExceeded(f"DEADLINE_EXCEEDED: request {why}")
        req._latency_s = time.monotonic() - req.t_arrive
        obs.add("serving.requests.deadline")
        self._close_request_trace(req, resilience.DEADLINE)
        req.event.set()

    def _finish_error(self, req: _Request, kind: str, err: BaseException) -> None:
        req.verdict = kind
        req.error = err
        req._latency_s = time.monotonic() - req.t_arrive
        obs.add(f"serving.requests.{kind.lower()}")
        self._close_request_trace(req, kind)
        req.event.set()

    def _finish_rejected(self, req: _Request, err: BaseException) -> None:
        """Capacity-rejected: a FIRST-CLASS classified verdict
        — the admission controller refused the dispatch after its
        eviction attempt; the device allocator never saw it (this is
        exactly NOT an OOM)."""
        req.verdict = "rejected"
        req.error = err
        req._latency_s = time.monotonic() - req.t_arrive
        obs.add("serving.requests.rejected")
        self._close_request_trace(req, "rejected")
        req.event.set()

    def _requeue_front(self, reqs: List[_Request], count: bool = True) -> None:
        # requeue accounting: survivors of a partial
        # deadline drain or an OOM cap-halving go back for a SECOND
        # admission — counted once here and flagged on their dispatch span,
        # so burn-rate math over the once-per-request verdict counters
        # never sees their first admission twice. A capacity QUEUE hold
        # passes count=False: a held batch was never
        # dispatched, and re-counting it every ~2ms hold cycle would
        # inflate the once-per-request series by orders of magnitude —
        # holds have their own counter (serving.capacity.held).
        if count:
            for req in reqs:
                req.requeued = True
            if obs.enabled():
                obs.add("serving.queue.requeued", len(reqs))
        with self._cv:
            for req in reversed(reqs):
                self._pending.appendleft(req)
            self._cv.notify()

    def _dispatch(self, batch: List[_Request]) -> None:
        n = len(batch)
        bucket = self._bucket_for(n)
        qarr = np.stack([r.query for r in batch])
        if bucket != n:
            # pad with copies of row 0: a real vector (not zeros) so the
            # padded rows cannot produce NaN/inf surprises in the scan
            qarr = np.concatenate(
                [qarr, np.repeat(qarr[:1], bucket - n, axis=0)])
        now = time.monotonic()
        budget = min(r.t_deadline for r in batch) - now
        verdict_rec = None
        if self._cost_model is not None:
            # pre-dispatch admission: predict the batch's footprint,
            # check admission, record the classified verdict — never
            # raises
            from raft_tpu_torch.obs import costmodel

            try:
                predicted = self._cost_model(bucket)
            except Exception as e:
                record_event("serving_cost_model_error",
                             kind=resilience.classify(e),
                             error=repr(e)[:200])
                predicted = None
            if predicted is not None:
                if self._capacity is not None:
                    # the controller's verdict is final AFTER its own
                    # eviction attempt (REJECT → demote LRU tenants →
                    # re-check); it never raises
                    try:
                        verdict_rec = self._capacity.admit(
                            predicted, entry="serving.dispatch",
                            tenant=self._tenant)
                    except Exception as e:
                        record_event("serving_capacity_error",
                                     kind=resilience.classify(e),
                                     error=repr(e)[:200])
                        verdict_rec = None
                else:
                    verdict_rec = costmodel.check_admission(
                        predicted, entry="serving.dispatch")
            if self._capacity is not None and verdict_rec is not None:
                if verdict_rec["verdict"] == costmodel.QUEUE:
                    # hold under the requests' own deadlines: requeue at
                    # the front with a short backoff — the next pumps
                    # re-check admission, and requests past deadline
                    # drain classified (never a hang)
                    if obs.enabled():
                        obs.add("serving.capacity.held")
                    with self._cv:
                        self._hold_until = time.monotonic() + max(
                            self.pressure_margin_s, 1e-3)
                    self._requeue_front(batch, count=False)
                    return
                if verdict_rec["verdict"] == costmodel.REJECT:
                    from raft_tpu_torch.serving.capacity import \
                        CapacityRejected

                    if obs.enabled():
                        obs.add("serving.capacity.rejected_batches")
                    err = CapacityRejected(
                        f"batch of {n} rejected by admission: projected "
                        f"{verdict_rec.get('projected_bytes')} of "
                        f"{verdict_rec.get('budget_bytes')} bytes "
                        f"(shortfall "
                        f"{verdict_rec.get('shortfall_bytes')} B after "
                        f"eviction)")
                    for req in batch:
                        self._finish_rejected(req, err)
                    return
        attrs = None
        if obs.enabled():
            attrs = {"batch": n, "bucket": bucket,
                     "cap": self._batch_cap,
                     "requeued": sum(1 for r in batch if r.requeued)}
            if verdict_rec is not None:
                attrs["admission"] = verdict_rec["verdict"]
        try:
            with obs.record_span("serving::dispatch", attrs=attrs):
                resilience.faultpoint("serving.queue.dispatch")
                with resilience.Deadline(max(budget, 0.0),
                                         label="serving.dispatch"):
                    # ledger watch: a mid-traffic retrace inside this
                    # dispatch gets the dispatch's wall-clock stamped on
                    # its ledger record (obs/compile.py)
                    with obs_compile.watch():
                        vals, ids = self._search_fn(qarr)
                    # the host copy INSIDE the deadline scope waits for the
                    # kernels: a result is only served once it exists
                    vals = _host(vals)
                    ids = _host(ids)
        except Exception as e:
            self._on_dispatch_error(batch, e, resilience.classify(e))
            return
        dt = time.monotonic() - now
        with self._cv:
            prev = self._lat_ewma.get(bucket)
            self._lat_ewma[bucket] = (dt if prev is None
                                      else 0.7 * prev + 0.3 * dt)
            self.batches += 1
            if n > 1:
                self.multi_batches += 1
        if obs.enabled():
            obs.observe("serving.batch_latency_s", dt)
            obs.observe("serving.batch.size", n)
            obs.add("serving.batches")
            if n > 1:
                obs.add("serving.batches.multi")
        done = time.monotonic()
        dispatch_epoch = time.time() - dt  # epoch twin of `now`
        for i, req in enumerate(batch):
            req.vals = vals[i]
            req.ids = ids[i]
            req.verdict = _OK
            req._latency_s = done - req.t_arrive
            if obs.enabled():
                if req.trace_id is not None:
                    # lifecycle children under the request root: admit
                    # (covers the queue wait) and dispatch (this batch)
                    wait_s = (req.t_admit or now) - req.t_arrive
                    obs.tracing.manual_span(
                        "serving::admit", t0=req.t_epoch, dur_s=wait_s,
                        trace_id=req.trace_id, parent_id=req.span_id,
                        attrs={"queue_wait_s": wait_s,
                               "requeued": req.requeued})
                    obs.tracing.manual_span(
                        "serving::dispatch", t0=dispatch_epoch, dur_s=dt,
                        trace_id=req.trace_id, parent_id=req.span_id,
                        attrs={"batch_size": n, "bucket": bucket,
                               "queue_wait_s": wait_s,
                               "requeued": req.requeued})
                # exemplar-linked: the latency histogram's percentile
                # buckets dereference to these request traces
                obs.observe("serving.request_latency_s", req._latency_s,
                            trace_id=req.trace_id)
                self._close_request_trace(req, _OK)
            req.event.set()
        if obs.enabled():
            obs.add("serving.requests.ok", n)
        shadow = self._shadow
        if shadow is not None:
            # off-hot-path recall estimation: one seeded decision per
            # request; enqueue-or-drop, never blocks the verdict (requests
            # were already completed above)
            for i, req in enumerate(batch):
                shadow.offer(req.query, ids[i], trace_id=req.trace_id)

    def _on_dispatch_error(self, batch: List[_Request], e: Exception,
                           kind: str) -> None:
        obs.add(f"serving.dispatch.{kind.lower()}")
        record_event("serving_dispatch_error", kind=kind, batch=len(batch),
                     error=repr(e)[:200])
        now = time.monotonic()
        if kind == resilience.OOM and self._batch_cap > 1:
            # adaptive degradation: halve the cap and requeue — the next
            # pumps re-dispatch the same requests in smaller batches
            with self._cv:
                cap = self._batch_cap = max(1, self._batch_cap // 2)
            obs.add("serving.dispatch.oom_halved")
            record_event("serving_batch_halved", cap=cap)
            self._requeue_front(batch)
            return
        if kind in (resilience.DEADLINE, resilience.TRANSIENT):
            # partial drain: requests already past deadline get their
            # DEADLINE verdict; survivors retry once, then fail classified
            retry = []
            for req in batch:
                if req.t_deadline <= now or (kind == resilience.DEADLINE
                                             and req.retries >= 1):
                    self._finish_deadline(req, "deadline during dispatch")
                elif req.retries >= 1:
                    self._finish_error(req, kind, e)
                else:
                    req.retries += 1
                    retry.append(req)
            if retry:
                self._requeue_front(retry)
            return
        for req in batch:  # OOM-at-cap-1 and FATAL: deliver classified
            self._finish_error(req, kind, e)

    # -- worker -------------------------------------------------------------
    def start(self) -> None:
        """Run the scheduler on a daemon worker thread."""
        if self._worker is not None and self._worker.is_alive():
            return
        with self._cv:
            self._stopping = False
        self._worker = threading.Thread(
            target=self._serve_loop, name="raft-tpu-torch-serving",
            daemon=True)
        self._worker.start()

    def _serve_loop(self) -> None:
        while not self._stopping:
            if self.pump():
                continue
            with self._cv:
                if self._stopping:
                    break
                # wake on submit, or poll at a fraction of the fill wait
                self._cv.wait(timeout=max(self.fill_wait_s / 4, 1e-3))

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the worker; by default first drains queued requests."""
        if drain:
            self.drain(timeout=timeout)
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
            self._worker = None

    def drain(self, timeout: float = 30.0) -> None:
        """Serve until the queue is empty (worker running or not)."""
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end:
            with self._cv:
                empty = not self._pending
            if empty:
                return
            if self._worker is None or not self._worker.is_alive():
                self.pump()
            else:
                time.sleep(1e-3)
        raise TimeoutError(f"queue did not drain within {timeout}s")

    @property
    def depth(self) -> int:
        with self._cv:
            return len(self._pending)

    @property
    def batch_cap(self) -> int:
        """Current adaptive batch-size cap (halved by OOM dispatches)."""
        return self._batch_cap

    def set_batch_cap(self, cap: int) -> int:
        """Clamp the live dispatch cap — the burn-rate controller's batch
        actuator. Never above ``max_batch`` (no new compiled
        bucket can appear mid-serving), never below 1; returns the cap
        actually installed. The next ``pump`` dispatches under it."""
        with self._cv:
            self._batch_cap = max(1, min(int(cap), self.max_batch))
            self._cv.notify_all()
            return self._batch_cap

    def knobs(self) -> dict:
        """The queue's live config-knob vector — the serving slice of the
        flight recorder's fingerprint (obs/flight.py). Includes the
        ADAPTIVE batch cap, so an OOM-halved window lands as a distinct
        fingerprint group on the frontier, not averaged into the sized
        configuration it no longer runs."""
        return {
            "max_batch": self.max_batch,
            "batch_cap": int(self._batch_cap),
            "slo_s": self.slo_s,
            "fill_wait_s": self.fill_wait_s,
        }
