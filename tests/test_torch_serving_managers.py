"""The port's serving managers — ``QueryQueue``, ``CompactionManager``,
``MaintenanceManager``, ``CapacityController`` — and ``obs/shadow``, held
against the JAX package's on the same numpy-seeded inputs, with indexes
built in JAX and carried into the port.

* Queue: every request's ids equal a direct search of it and the JAX
  queue's answer; the same batch-size ladder reaches the search function;
  coalescing, OOM halving, requeue accounting, deadline drains, the cost
  hook and a broken cost model, as the JAX package's tests hold them. The
  queue is driven by ``pump()``.
* Compaction: after the same mutations, the port's swapped store answers
  as the JAX compacted store does.
* Maintenance: the same drift score, list skew and pairs; after one
  re-clustering the centers and labels equal JAX's bit for bit (host
  numpy), the codes equal but at ties, recall within 0.005.
* Capacity: the same tier counts and demotion order as JAX's controller,
  and a warm serve equal to JAX's.
* Every manager faultpoint surfaces classified into a verdict or a status.
"""

import time

import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu import resilience as jres
from raft_tpu import serving as jsv
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_bq as jbq
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.obs import shadow as jshadow
from raft_tpu.serving import capacity as jcap
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import resilience as tres
from raft_tpu_torch import serving as tsv
from raft_tpu_torch.neighbors import ivf_bq as tbq
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.obs import costmodel as tcm
from raft_tpu_torch.obs import memory as tmem
from raft_tpu_torch.obs import shadow as tshadow
from raft_tpu_torch.resilience.deadline import DeadlineExceeded
from raft_tpu_torch.serving import capacity as tcap

torch.set_num_threads(2)

CPU = "cpu"
DIM = 16


@pytest.fixture(autouse=True)
def _clean_state():
    for res in (tres, jres):
        res.clear_faults()
        res.clear_events()
    for ob in (jobs, tobs):
        ob.disable()
        ob.reset()
        ob.tracing.clear_spans()
    yield
    for res in (tres, jres):
        res.clear_faults()
    for ob in (jobs, tobs):
        ob.disable()
        ob.reset()
        ob.tracing.clear_spans()


def carry_flat(j):
    arrays = {k: np.asarray(getattr(j, k)) for k in
              ("centers", "list_data", "list_ids")}
    if j.list_norms is not None:
        arrays["list_norms"] = np.asarray(j.list_norms)
    return tfl.from_jax_arrays({"kind": "ivf_flat", "metric": j.metric,
                                "group_size": j.group_size}, arrays,
                               device=CPU)


def carry_pq(j):
    arrays = {k: np.asarray(getattr(j, k)) for k in
              ("centers", "rotation", "codebooks", "list_codes", "list_ids",
               "b_sum")}
    return tpq.from_jax_arrays(
        {"kind": "ivf_pq", "metric": j.metric, "pq_bits": j.pq_bits,
         "group_size": j.group_size, "codebook_kind": j.codebook_kind,
         "pq_dim_hint": j.pq_dim_hint}, arrays, device=CPU)


def carry_bq(j):
    arrays = {k: np.asarray(getattr(j, k)) for k in
              ("centers", "rotation", "list_codes", "list_ids", "list_scale",
               "list_bias")}
    return tbq.from_jax_arrays({"kind": "ivf_bq", "metric": j.metric,
                                "bits": j.bits,
                                "rotation_kind": j.rotation_kind}, arrays,
                               device=CPU)


def _ids(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


@pytest.fixture(scope="module")
def flat():
    rng = np.random.default_rng(21)
    X = rng.standard_normal((2000, DIM)).astype(np.float32)
    j = jfl.build(X, jfl.IvfFlatParams(n_lists=8, list_size_cap=0,
                                       kmeans_n_iters=5))
    return X, j, carry_flat(j)


@pytest.fixture
def stores(flat):
    """A JAX store and the port's over the same carried index; the port
    searches with the gather scan, JAX's CPU engine (exact fp32)."""
    _, j, t = flat
    return (jsv.PagedListStore.from_index(j, page_rows=64),
            tsv.PagedListStore.from_index(t, page_rows=64, device=CPU))


def _port_searcher(store, k=5, n_probes=8):
    return tsv.searcher(store, k, n_probes=n_probes, backend="gather",
                        device=CPU)


def _drain(q, timeout=30.0):
    t_end = time.monotonic() + timeout
    while q.depth and time.monotonic() < t_end:
        q.pump()
    assert not q.depth, "queue failed to drain"


def _queries(seed, n):
    return np.random.default_rng(seed).standard_normal(
        (n, DIM)).astype(np.float32)


# ---------------------------------------------------------------------------
# QueryQueue
# ---------------------------------------------------------------------------


def test_queue_ids_equal_direct_search_and_the_jax_queue(stores):
    jstore, tstore = stores
    qs = _queries(1, 16)
    got = []
    for sv, searcher in ((tsv, _port_searcher(tstore, 5, 12)),
                         (jsv, jsv.searcher(jstore, k=5, n_probes=12))):
        q = sv.QueryQueue(searcher, slo_s=0.05, max_batch=16)
        hs = [q.submit(qs[i], timeout_s=10.0) for i in range(16)]
        _drain(q)
        assert all(h.verdict == "ok" for h in hs)
        got.append(np.stack([_ids(h.result()[1]) for h in hs]))
    _, direct = tsv.search(tstore, qs, 5, n_probes=12, backend="gather",
                           device=CPU)
    np.testing.assert_array_equal(got[0], _ids(direct))
    np.testing.assert_array_equal(got[0], got[1])


def test_queue_feeds_the_same_bucket_ladder_as_jax(stores):
    """Arbitrary arrivals reach the search function in the pow2 buckets
    of the JAX queue, padded with the first query."""
    seen = {"port": [], "jax": []}

    def recorder(name):
        def fn(qarr):
            seen[name].append(int(np.asarray(qarr).shape[0]))
            n = qarr.shape[0]
            return np.zeros((n, 5), np.float32), np.zeros((n, 5), np.int32)
        return fn

    for name, sv in (("port", tsv), ("jax", jsv)):
        q = sv.QueryQueue(recorder(name), slo_s=0.05, max_batch=8)
        assert q.buckets == [1, 2, 4, 8]
        for burst in (13, 3, 1, 6):
            for i in range(burst):
                q.submit(np.zeros(DIM, np.float32), timeout_s=10.0)
            while q.depth:
                q.pump(now=time.monotonic() + 1.0)
    assert seen["port"] == seen["jax"] == [8, 8, 4, 1, 8]


def test_queue_serves_a_bq_store_through_k4s_path(flat):
    """A BQ store behind the queue: each request's ids equal a direct
    paged search of it (K4's twin here, K4 on a card)."""
    X, _, _ = flat
    j = jbq.build(X, jbq.IvfBqParams(n_lists=8, kmeans_n_iters=5))
    store = tsv.PagedListStore.from_index(carry_bq(j), page_rows=64,
                                          device=CPU)
    qs = _queries(18, 12)
    q = tsv.QueryQueue(tsv.searcher(store, 10, n_probes=4, device=CPU),
                       slo_s=0.05, max_batch=16)
    hs = [q.submit(x, timeout_s=10.0) for x in qs]
    _drain(q)
    _, direct = tsv.search(store, qs, 10, n_probes=4, device=CPU)
    np.testing.assert_array_equal(np.stack([h.result()[1] for h in hs]),
                                  _ids(direct))


def test_coalesces_into_multi_batches(stores):
    _, tstore = stores
    q = tsv.QueryQueue(_port_searcher(tstore), slo_s=0.05, max_batch=8)
    hs = [q.submit(x, timeout_s=10.0) for x in _queries(2, 24)]
    _drain(q)
    assert all(h.verdict == "ok" for h in hs)
    assert q.multi_batches >= 1
    vals, ids = hs[0].result()
    assert vals.shape == (5,) and ids.shape == (5,)
    assert isinstance(ids, np.ndarray)


def test_expired_request_gets_deadline_verdict(stores):
    _, tstore = stores
    q = tsv.QueryQueue(_port_searcher(tstore), slo_s=0.05)
    h = q.submit(_queries(3, 1)[0], timeout_s=0.0)
    time.sleep(0.01)
    q.pump()
    assert h.verdict == tres.DEADLINE
    with pytest.raises(DeadlineExceeded):
        h.result()


def test_oom_halves_batch_size(stores):
    _, tstore = stores
    tobs.enable()
    q = tsv.QueryQueue(_port_searcher(tstore), slo_s=0.05, max_batch=8)
    tres.arm_faults("serving.queue.dispatch=oom:1")
    hs = [q.submit(x, timeout_s=10.0) for x in _queries(4, 8)]
    _drain(q)
    assert all(h.verdict == "ok" for h in hs)
    assert q.batch_cap == 4
    assert tobs.snapshot()["counters"].get("serving.dispatch.oom_halved") == 1


def test_fatal_dispatch_is_classified_then_the_queue_serves(stores):
    _, tstore = stores
    q = tsv.QueryQueue(_port_searcher(tstore), slo_s=0.05, max_batch=4)
    tres.arm_faults("serving.queue.dispatch=fatal:1")
    bad = [q.submit(x, timeout_s=10.0) for x in _queries(5, 2)]
    _drain(q)
    assert all(h.verdict == tres.FATAL for h in bad)
    ok = q.submit(_queries(6, 1)[0], timeout_s=10.0)
    _drain(q)
    assert ok.verdict == "ok"


def test_transient_dispatch_retries_once(stores):
    _, tstore = stores
    q = tsv.QueryQueue(_port_searcher(tstore), slo_s=0.05, max_batch=4)
    tres.arm_faults("serving.queue.dispatch=transient:1")
    hs = [q.submit(x, timeout_s=10.0) for x in _queries(7, 4)]
    _drain(q)
    assert all(h.verdict == "ok" for h in hs)


def test_requeued_survivors_counted_once(stores):
    _, tstore = stores
    tobs.enable()
    q = tsv.QueryQueue(_port_searcher(tstore), slo_s=0.05, max_batch=8)
    tres.arm_faults("serving.queue.dispatch=oom:1")
    hs = [q.submit(x, timeout_s=10.0) for x in _queries(8, 8)]
    _drain(q)
    assert all(h.verdict == "ok" for h in hs)
    counters = tobs.snapshot()["counters"]
    assert counters["serving.queue.requeued"] == 8
    assert counters["serving.requests.ok"] == 8
    assert counters["serving.queue.submits"] == 8
    dspans = [s for s in tobs.tracing.spans()
              if s["name"] == "serving::dispatch"
              and s.get("trace_id") == hs[0].trace_id]
    assert dspans and dspans[-1]["attrs"]["requeued"] is True
    roots = [s for s in tobs.tracing.spans()
             if s["name"] == "serving::request"]
    assert len(roots) == 8 and all(s["attrs"]["requeued"] for s in roots)


def test_partial_deadline_drain_requeues_survivors(stores):
    _, tstore = stores
    tobs.enable()
    q = tsv.QueryQueue(_port_searcher(tstore), slo_s=0.05, max_batch=8)
    tres.arm_faults("serving.queue.dispatch=hang:1:10")
    short = [q.submit(x, timeout_s=0.15) for x in _queries(9, 3)]
    longer = [q.submit(x, timeout_s=30.0) for x in _queries(10, 3)]
    _drain(q, timeout=20.0)
    assert [h.verdict for h in short] == [tres.DEADLINE] * 3
    assert [h.verdict for h in longer] == ["ok"] * 3
    counters = tobs.snapshot()["counters"]
    assert counters["serving.queue.requeued"] == 3
    assert counters["serving.requests.ok"] == 3
    assert counters["serving.requests.deadline"] == 3


def test_telemetry_off_allocates_no_trace(stores):
    _, tstore = stores
    q = tsv.QueryQueue(_port_searcher(tstore), slo_s=0.05, max_batch=4)
    hs = [q.submit(x, timeout_s=10.0) for x in _queries(11, 6)]
    _drain(q)
    assert all(h.verdict == "ok" and h.trace_id is None for h in hs)
    assert tobs.tracing.spans() == []


def test_request_trace_lifecycle(stores):
    _, tstore = stores
    tobs.enable()
    q = tsv.QueryQueue(_port_searcher(tstore), slo_s=0.05, max_batch=4)
    h = q.submit(_queries(12, 1)[0], timeout_s=10.0)
    _drain(q)
    names = {s["name"] for s in tobs.tracing.spans()
             if s["trace_id"] == h.trace_id}
    assert {"serving::submit", "serving::admit", "serving::dispatch",
            "serving::complete", "serving::request"} <= names


def test_queue_cost_hook_records_verdicts(stores):
    _, tstore = stores
    tobs.enable()
    q = tsv.QueryQueue(_port_searcher(tstore, 3, 4), slo_s=0.5,
                       max_batch=4,
                       cost_model=tcm.paged_scan_estimator(tstore, 3, 4))
    hs = [q.submit(x, timeout_s=10.0) for x in _queries(13, 8)]
    _drain(q)
    assert all(h.verdict == "ok" for h in hs)
    counts = tcm.admission_counts(tobs.snapshot()["counters"])
    assert sum(counts.values()) == q.batches >= 2
    assert [s for s in tobs.tracing.spans()
            if s["name"] == "serving::dispatch"
            and (s.get("attrs") or {}).get("admission")]


def test_queue_broken_cost_model_never_fails_requests(stores):
    _, tstore = stores

    def broken(batch):
        raise RuntimeError("cost model down")

    q = tsv.QueryQueue(_port_searcher(tstore, 3, 4), slo_s=0.5, max_batch=4,
                       cost_model=broken)
    h = q.submit(_queries(14, 1)[0], timeout_s=10.0)
    _drain(q)
    assert h.verdict == "ok"
    assert any(e.get("event") == "serving_cost_model_error"
               for e in tres.recent_events())


def test_worker_thread_serves(stores):
    _, tstore = stores
    q = tsv.QueryQueue(_port_searcher(tstore), slo_s=0.02, max_batch=16)
    q.start()
    try:
        hs = [q.submit(x, timeout_s=10.0) for x in _queries(15, 20)]
        for h in hs:
            h.result(timeout=15.0)
    finally:
        q.stop()
    assert all(h.verdict == "ok" for h in hs)


def test_shadow_sampler_matches_jax_decisions_and_scores(stores):
    jstore, tstore = stores
    assert [tshadow.sample_decision(3, s, 0.25) for s in range(64)] == \
        [jshadow.sample_decision(3, s, 0.25) for s in range(64)]
    for m, t in ((0, 0), (7, 10), (10, 10), (95, 100)):
        assert tshadow.wilson_interval(m, t) == jshadow.wilson_interval(m, t)
    ests = []
    for sh_mod, sv, store, kw in (
            (tshadow, tsv, tstore, {"backend": "gather", "device": CPU}),
            (jshadow, jsv, jstore, {})):
        exact = (lambda q, sv=sv, store=store, kw=kw:
                 sv.search(store, q, 5, n_probes=8, **kw))
        sh = sh_mod.ShadowSampler(exact, k=5, rate=0.5, seed=4)
        q = sv.QueryQueue(sv.searcher(store, 5, n_probes=2, **kw),
                          slo_s=0.05, max_batch=8, shadow=sh)
        for x in _queries(16, 16):
            q.submit(x, timeout_s=10.0)
        _drain(q)
        while sh.pump():
            pass
        ests.append(sh.estimate())
    assert ests[0] == ests[1] and ests[0]["samples"] > 0


def test_shadow_faultpoint_goes_stale_classified(stores):
    _, tstore = stores
    sh = tshadow.ShadowSampler(
        lambda q: tsv.search(tstore, q, 5, n_probes=8, device=CPU), k=5,
        rate=1.0)
    tres.arm_faults("obs.shadow.search=fatal:1")
    sh.offer(_queries(17, 1)[0], np.arange(5))
    assert sh.pump()
    est = sh.estimate()
    assert est["errors"] == 1 and est["stale"]
    sh.offer(_queries(17, 1)[0], np.arange(5))
    sh.pump()
    assert not sh.estimate()["stale"]


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------


def _mutate(store, seed):
    rng = np.random.default_rng(seed)
    store.upsert(rng.standard_normal((300, DIM)).astype(np.float32),
                 np.arange(100_000, 100_300))
    store.delete(np.arange(0, 600, 2))
    store.delete(np.arange(100_000, 100_050))


def test_compaction_swap_answers_as_the_jax_compacted_store(stores):
    jstore, tstore = stores
    qs = _queries(20, 12)
    outs = []
    for sv, store, kw in ((jsv, jstore, {}),
                          (tsv, tstore, {"backend": "gather",
                                         "device": CPU})):
        _mutate(store, 3)
        _, before = sv.search(store, qs, 10, n_probes=8, **kw)
        cap0, width0 = store.capacity_pages, store.table_width
        out = sv.CompactionManager(store, ratio=0.0).pump()
        assert out["status"] == "ok" and out["reclaimed"] == 350
        assert store.tombstones == 0
        assert (store.capacity_pages, store.table_width) == (cap0, width0)
        _, after = sv.search(store, qs, 10, n_probes=8, **kw)
        np.testing.assert_array_equal(_ids(before), _ids(after))
        outs.append(_ids(after))
    np.testing.assert_array_equal(outs[0], outs[1])
    # the port's default engine (K3's twin: bf16 products) finds the same
    # neighbours but where bf16 rounding reorders near-ties
    _, paged = tsv.search(tstore, qs, 10, n_probes=8, device=CPU)
    overlap = np.mean([len(set(a) & set(b)) / 10.0
                       for a, b in zip(_ids(paged), outs[1])])
    assert overlap >= 0.95


@pytest.mark.parametrize("spec,status", [
    ("serving.compact.run=oom:1", "oom"),
    ("serving.compact.run=fatal:1", "fatal")])
def test_compaction_faultpoint_classified(stores, spec, status):
    _, tstore = stores
    _mutate(tstore, 4)
    mgr = tsv.CompactionManager(tstore, ratio=0.0)
    tres.arm_faults(spec)
    out = mgr.pump()
    assert out["status"] == status and mgr.failures == 1
    assert tstore.tombstones > 0
    assert mgr.pump()["status"] == "ok" and tstore.tombstones == 0


def test_compaction_stale_on_a_racing_mutation(stores, monkeypatch):
    _, tstore = stores
    _mutate(tstore, 5)
    mgr = tsv.CompactionManager(tstore, ratio=0.0)
    fold = tstore.compact

    def racing_compact():
        packed = fold()
        tstore.upsert(_queries(21, 1), np.array([555_555]))
        return packed

    monkeypatch.setattr(tstore, "compact", racing_compact)
    assert mgr.pump()["status"] == "stale" and mgr.stale_swaps == 1
    monkeypatch.setattr(tstore, "compact", fold)
    assert mgr.pump()["status"] == "ok"


# ---------------------------------------------------------------------------
# maintenance
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pq_setup():
    """A JAX IVF-PQ index and its port copy, plus a far-away blob that
    piles onto one list once upserted (the drift the managers act on)."""
    rng = np.random.default_rng(31)
    base = rng.standard_normal((1500, DIM)).astype(np.float32)
    blob = rng.standard_normal((500, DIM)).astype(np.float32) * 0.2 + 6.0
    j = jpq.build(base, jpq.IvfPqParams(n_lists=8, pq_dim=8,
                                        list_size_cap=0, kmeans_n_iters=5))
    return base, blob, j, carry_pq(j)


def _skewed_pair(pq_setup):
    base, blob, j, t = pq_setup
    rows = np.concatenate([base, blob])
    ids = np.arange(base.shape[0], rows.shape[0], dtype=np.int64)
    jstore = jsv.PagedListStore.from_index(j, page_rows=64)
    tstore = tsv.PagedListStore.from_index(t, page_rows=64, device=CPU)
    for store in (jstore, tstore):
        store.upsert(blob, ids)
    return rows, jstore, tstore


def _mgr(sv, store, rows, **kw):
    kw.setdefault("compaction", None)
    return sv.MaintenanceManager(
        store, drift_threshold=0.5, split_skew=1.5, min_split_rows=8,
        row_source=lambda ids: rows[np.asarray(ids)], **kw)


def _rows_by_id(store):
    payload, _, _, ids, labels = store._live_rows()
    order = np.argsort(ids)
    return ids[order], labels[order], _ids(payload)[order]


def test_maintenance_detect_and_plan_equal_jax(pq_setup):
    rows, jstore, tstore = _skewed_pair(pq_setup)
    jm, tm = _mgr(jsv, jstore, rows), _mgr(tsv, tstore, rows)
    jd, td = jm.detect(), tm.detect()
    assert td["drifted"] and jd["drifted"]
    for key in ("drift_score", "list_skew", "tombstone_ratio", "dominant",
                "components"):
        assert td[key] == jd[key], key
    np.testing.assert_array_equal(tstore.list_fill_counts(),
                                  jstore.list_fill_counts())
    assert tm._plan_pairs(tstore.list_fill_counts()) == \
        jm._plan_pairs(jstore.list_fill_counts())


def test_maintenance_recluster_equals_jax(pq_setup):
    rows, jstore, tstore = _skewed_pair(pq_setup)
    jm, tm = _mgr(jsv, jstore, rows), _mgr(tsv, tstore, rows)
    skew0 = tstore.list_skew()
    t_out, j_out = tm.recluster(), jm.recluster()
    assert t_out["status"] == j_out["status"] == "ok"
    assert (t_out["pairs"], t_out["rows_moved"]) == \
        (j_out["pairs"], j_out["rows_moved"])
    assert tstore.list_skew() < skew0
    np.testing.assert_array_equal(_ids(tstore.centers),
                                  np.asarray(jstore.centers))
    t_ids, t_lab, t_codes = _rows_by_id(tstore)
    j_ids, j_lab, j_codes = _rows_by_id(jstore)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_array_equal(t_lab, j_lab)
    assert (t_codes == j_codes).all(axis=1).mean() >= 0.99
    # recall@10 of the maintained stores against exact ground truth
    qs = np.concatenate([_queries(30, 20), rows[-20:] + 0.01])
    _, gt = jbf.knn(qs, rows, 10)
    gt = np.asarray(gt)

    def recall(ids):
        return np.mean([len(set(a) & set(b)) / 10.0
                        for a, b in zip(_ids(ids), gt)])

    r_t = recall(tsv.search(tstore, qs, 10, n_probes=8, backend="gather",
                            device=CPU)[1])
    r_j = recall(jsv.search(jstore, qs, 10, n_probes=8)[1])
    assert abs(r_t - r_j) <= 0.005


def test_maintenance_keeps_scan_shapes(pq_setup):
    rows, _, tstore = _skewed_pair(pq_setup)
    mgr = _mgr(tsv, tstore, rows)
    qs = _queries(32, 8)
    tsv.search(tstore, qs, 10, n_probes=4, device=CPU)
    t0 = tsv.scan_trace_count()
    for _ in range(3):
        mgr.pump()
        tsv.search(tstore, qs, 10, n_probes=4, device=CPU)
    assert mgr.report()["cycles"] >= 1
    assert tsv.scan_trace_count() == t0


def test_maintenance_flat_store_reclusters_from_its_payload(flat):
    X, _, t = flat
    store = tsv.PagedListStore.from_index(t, page_rows=64, device=CPU)
    rng = np.random.default_rng(33)
    store.upsert(rng.standard_normal((600, DIM)).astype(np.float32) * 0.2
                 + 6.0, np.arange(10_000, 10_600))
    mgr = tsv.MaintenanceManager(store, drift_threshold=0.5, split_skew=1.5)
    out = mgr.pump()
    assert out["status"] == "ok" and out["recluster"]["pairs"] >= 1
    assert store.size == X.shape[0] + 600


def test_maintenance_detect_faultpoint_classifies(pq_setup):
    rows, _, tstore = _skewed_pair(pq_setup)
    mgr = _mgr(tsv, tstore, rows)
    tres.arm_faults("serving.maintenance.detect=transient:1")
    out = mgr.pump()
    assert out["status"] == tres.TRANSIENT and out["phase"] == "detect"
    assert mgr.report()["failures"] == 1
    assert mgr.detect()["drifted"]


def test_maintenance_recluster_faultpoint_then_recovers(pq_setup):
    rows, _, tstore = _skewed_pair(pq_setup)
    mgr = _mgr(tsv, tstore, rows)
    skew0 = tstore.list_skew()
    tres.arm_faults("serving.maintenance.recluster=oom:1")
    assert mgr.recluster()["status"] == tres.OOM
    assert tstore.list_skew() == pytest.approx(skew0)
    assert mgr.recluster()["status"] == "ok"


def test_maintenance_swap_faultpoint_aborts_the_cycle(pq_setup):
    rows, _, tstore = _skewed_pair(pq_setup)
    mgr = _mgr(tsv, tstore, rows)
    v0 = tstore.mutation_version
    tres.arm_faults("serving.maintenance.swap=fatal:1")
    assert mgr.recluster()["status"] == tres.FATAL
    assert tstore.mutation_version == v0
    assert mgr.recluster()["status"] == "ok"
    assert tstore.mutation_version > v0


def test_recluster_swap_refuses_a_stale_version(pq_setup):
    rows, _, tstore = _skewed_pair(pq_setup)
    clone = tstore._empty_clone()
    v0 = tstore.mutation_version
    tstore.delete(np.arange(3))
    assert not tstore.recluster_swap(clone, v0)


def test_restore_shape_pregrows_and_builds_the_table_mirror(flat):
    _, _, t = flat
    store = tsv.PagedListStore.from_index(t, page_rows=64, device=CPU)
    cap, width = store.capacity_pages, store.table_width
    store.restore_shape(cap * 4, width * 2)
    assert store.capacity_pages == cap * 4
    assert store.table_width >= width * 2
    assert store._dev_table is not None
    g = store.growth_events
    store.restore_shape(cap, width)              # never shrinks
    assert store.growth_events == g


# ---------------------------------------------------------------------------
# capacity
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def plane():
    """Four JAX-built tenants with JAX-built warm twins, and their port
    copies (the warm twin's random rotation cannot be reproduced, so both
    controllers take the same twin)."""
    tenants = {}
    for i in range(4):
        r = np.random.default_rng(i)
        X = r.standard_normal((600 + 100 * i, DIM)).astype(np.float32)
        j = jfl.build(X, jfl.IvfFlatParams(n_lists=8, list_size_cap=0))
        jw, wids = jcap._warm_twin(j)
        tenants[f"t{i}"] = (X, (j, jw, wids), (carry_flat(j), carry_bq(jw)))
    return tenants


def _controllers(plane, budget, snap_dir, names=None):
    jc = jcap.CapacityController(budget_bytes=budget)
    tc = tcap.CapacityController(budget_bytes=budget, device=CPU)
    for name in names or sorted(plane):
        _, (j, jw, wids), (t, tw) = plane[name]
        jc.register(name, j, str(snap_dir / "jax"), warm_index=jw,
                    warm_ids=wids)
        tc.register(name, t, str(snap_dir / "port"), warm_index=tw,
                    warm_ids=wids)
    return jc, tc


def _full_bytes(plane, name):
    _, _, (t, tw) = plane[name]
    return tmem.index_bytes(t) + tmem.index_bytes(tw)


def _tiers(ctrl):
    return {n: ctrl.registry.get(n).tier for n in ctrl.registry.names()}


def _demotions(events):
    return [(e["tenant"], e["from"], e["to"]) for e in events
            if e.get("event") == "capacity_demote"]


def test_capacity_accounting_is_exact(plane, tmp_path):
    budget = int(sum(_full_bytes(plane, n) for n in plane) / 0.85) + (1 << 20)
    _, tc = _controllers(plane, budget, tmp_path)
    for name in tc.registry.names():
        t = tc.registry.get(name)
        assert t.tier == tcap.HOT
        assert t.hot_bytes == tmem.index_bytes(t.hot_obj)
        assert t.warm_bytes == tmem.index_bytes(t.warm_index)


@pytest.mark.parametrize("frac", [1.1, 2.3])
def test_capacity_tiers_and_demotions_equal_jax(plane, tmp_path, frac):
    """Registration under a tight budget, then serving every tenant in the
    same order: the same tier census and the same demotions, in order."""
    budget = int(_full_bytes(plane, "t0") * frac)
    jc, tc = _controllers(plane, budget, tmp_path)
    assert tc.registry.tier_counts() == jc.registry.tier_counts()
    assert _tiers(tc) == _tiers(jc)
    qs = _queries(40, 4)
    for name in ("t1", "t3", "t0", "t2", "t3"):
        outs = []
        for ctrl in (jc, tc):
            try:
                res = ctrl.search(name, qs, 5, n_probes=8)
                outs.append((res.tier, res.degraded))
            except (jcap.CapacityRejected, tcap.CapacityRejected):
                outs.append(("rejected", None))
        assert outs[0] == outs[1], name
    assert _tiers(tc) == _tiers(jc)
    assert _demotions(tres.recent_events()) == \
        _demotions(jres.recent_events())
    rep_t, rep_j = tc.report(), jc.report()
    for key in ("resident_bytes", "tenants_resident_hot",
                "tenants_resident_warm", "tenants_cold", "demotions",
                "rejections", "queued_degraded"):
        assert rep_t[key] == rep_j[key], key
    assert rep_t["resident_bytes"] <= budget


def test_capacity_warm_serve_equals_jax(plane, tmp_path):
    budget = int(sum(_full_bytes(plane, n) for n in plane) / 0.85) + (1 << 20)
    jc, tc = _controllers(plane, budget, tmp_path, names=["t1"])
    for ctrl in (jc, tc):
        ctrl.demote("t1")
        assert ctrl.registry.get("t1").tier == tcap.WARM
    qs = plane["t1"][0][:6] + 0.01
    jr = jc.search("t1", qs, 5, n_probes=32)
    tr = tc.search("t1", qs, 5, n_probes=32)
    assert tr.degraded and tr.tier == tcap.WARM
    assert (np.asarray(tr.indices) == np.asarray(jr.indices)).mean() >= 0.95
    # the ids are translated back into the tenant's own id space
    assert (np.asarray(tr.indices)[:, 0] == np.arange(
        plane["t1"][0].shape[0] - 6, plane["t1"][0].shape[0])).all() or \
        np.asarray(tr.indices).max() < plane["t1"][0].shape[0]


def test_capacity_promote_restores_and_measures(plane, tmp_path):
    budget = int(sum(_full_bytes(plane, n) for n in plane) / 0.85) + (1 << 20)
    _, tc = _controllers(plane, budget, tmp_path, names=["t2"])
    qs = _queries(41, 5)
    want = _ids(tc.search("t2", qs, 5, n_probes=8).indices)
    tc.demote("t2")
    tc.demote("t2")
    assert tc.registry.get("t2").tier == tcap.COLD
    out = tc.promote("t2")
    assert out["status"] == "ok" and out["promote_s"] > 0
    res = tc.search("t2", qs, 5, n_probes=8)
    assert res.tier == tcap.HOT
    np.testing.assert_array_equal(_ids(res.indices), want)
    assert tc.promote_latency()["count"] == 1


@pytest.mark.parametrize("spec,kind", [
    ("serving.capacity.promote=oom:1", "oom"),
    ("serving.capacity.promote=fatal:1", "fatal")])
def test_capacity_promote_fault_keeps_the_tier(plane, tmp_path, spec, kind):
    budget = int(sum(_full_bytes(plane, n) for n in plane) / 0.85) + (1 << 20)
    _, tc = _controllers(plane, budget, tmp_path, names=["t0"])
    tc.demote("t0")
    tres.arm_faults(spec)
    out = tc.promote("t0")
    assert out["status"] == "error" and out["kind"] == kind
    assert tc.registry.get("t0").tier == tcap.WARM
    assert tc.promote("t0")["status"] == "ok"


def test_capacity_upsert_buffers_while_warm_and_replays(flat, tmp_path):
    _, _, t = flat
    store = tsv.PagedListStore.from_index(t, page_rows=64, device=CPU)
    tc = tcap.CapacityController(budget_bytes=1 << 30, device=CPU)
    tc.register("live", store, str(tmp_path))
    tc.demote("live")
    assert tc.registry.get("live").tier == tcap.WARM
    row = _queries(42, 1) + 9.0
    assert tc.upsert("live", row, np.array([777_777]))["buffered"] == 1
    res = tc.search("live", row, 5, n_probes=8)
    assert res.degraded and int(np.asarray(res.indices)[0, 0]) == 777_777
    assert tc.promote("live")["replayed_rows"] == 1
    res = tc.search("live", row, 5, n_probes=8)
    assert res.tier == tcap.HOT and int(_ids(res.indices)[0, 0]) == 777_777


def test_queue_with_capacity_rejects_classified(plane, tmp_path):
    tobs.enable()
    _, _, (t, _) = plane["t0"]
    hot = tcm.predict_index_bytes(**tcm.index_layout(t))
    tc = tcap.CapacityController(budget_bytes=int(hot * 1.3), device=CPU)
    tc.register("solo", t, str(tmp_path), warm=False)
    assert tc.registry.get("solo").tier == tcap.HOT
    q = tsv.QueryQueue(
        lambda qs: tfl.search(t, qs, 5, n_probes=8, device=CPU),
        slo_s=0.2, max_batch=8, cost_model=tc.cost_model_for("solo", 5, 8),
        capacity=tc, tenant="solo")
    hs = [q.submit(x, timeout_s=5.0) for x in _queries(43, 5)]
    _drain(q, timeout=20.0)
    assert [h.verdict for h in hs] == ["rejected"] * 5
    assert tc.registry.get("solo").tier == tcap.HOT
    with pytest.raises(tcap.CapacityRejected):
        hs[0].result()
    assert tobs.snapshot()["counters"]["serving.requests.rejected"] == 5


def test_capacity_builds_on_the_card_unless_asked(monkeypatch, flat,
                                                  tmp_path):
    """Registration builds the warm twin on the controller's device:
    ``cuda`` by default, which raises without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcap.CapacityController(budget_bytes=1 << 30)
    tc = tcap.CapacityController(budget_bytes=1 << 30, device=CPU)
    tenant = tc.register("t", flat[2], str(tmp_path))
    assert tenant.warm_index.device.type == "cpu"
