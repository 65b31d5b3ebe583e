"""The port's obs cost layer — ``obs/compile``, ``obs/memory``,
``obs/costmodel``, ``obs/roofline`` — held against the JAX package's on
the same inputs.

* ``predict_index_bytes`` is the JAX formula: equal to JAX's on the same
  random layout draws for every family and the paged store, and exact
  against the port's ``memory.index_bytes`` on every index and store
  carried over from a JAX-built one (whose ``index_layout`` equals JAX's).
* ``estimate`` and ``roofline.estimate_flops`` equal JAX's for every
  registered entry; ``utilization`` and ``summary`` fold alike; the H100
  peaks and the env overrides (both or neither).
* Admission: the verdicts, the env budget, the worst card, never raising.
* The compile ledger: a store growth is recorded with the same shape diff
  as JAX's (``table`` widened from→to); a steady window records nothing; a
  new static is attributed; ``watch`` stamps its own thread only; the ring
  cap keeps counts; a kernel library loaded twice is an unexplained
  retrace.
* ``serving.search`` records the ``serving::search`` span and the
  ``serving.searches`` counter as JAX's does.
"""

import ctypes
import threading

import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu import serving as jsv
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import cagra as jcg
from raft_tpu.neighbors import ivf_bq as jbq
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.obs import compile as jcomp
from raft_tpu.obs import costmodel as jcm
from raft_tpu.obs import roofline as jrl
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import resilience as tres
from raft_tpu_torch import serving as tsv
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tcg
from raft_tpu_torch.neighbors import ivf_bq as tbq
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.obs import compile as tcomp
from raft_tpu_torch.obs import costmodel as tcm
from raft_tpu_torch.obs import memory as tmem
from raft_tpu_torch.obs import roofline as trl
from raft_tpu_torch.ops import _native

torch.set_num_threads(2)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    for env in (tcm.HBM_ENV, tcm.SOFT_ENV, tcm.HARD_ENV, trl.PEAK_FLOPS_ENV,
                trl.PEAK_BW_ENV):
        monkeypatch.delenv(env, raising=False)
    tres.clear_events()
    for ob, rl in ((jobs, jrl), (tobs, trl)):
        ob.disable()
        ob.reset()
        ob.tracing.clear_spans()
        rl.reset()
    yield
    for ob, rl in ((jobs, jrl), (tobs, trl)):
        ob.disable()
        ob.reset()
        ob.tracing.clear_spans()
        rl.reset()
    tobs.disable_sync()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    X = rng.standard_normal((2000, 16)).astype(np.float32)
    Q = rng.standard_normal((8, 16)).astype(np.float32)
    return X, Q


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


@pytest.fixture(scope="module")
def built(data):
    """JAX-built IVF indexes (512-row granule, as the strip paths want)
    and their port copies."""
    X, _ = data
    jf = jfl.build(X, jfl.IvfFlatParams(n_lists=8, group_size=512,
                                        kmeans_n_iters=5))
    jp = jpq.build(X, jpq.IvfPqParams(n_lists=8, pq_dim=8, group_size=512,
                                      kmeans_n_iters=5))
    jb = jbq.build(X, jbq.IvfBqParams(n_lists=8, kmeans_n_iters=5))
    return {"ivf_flat": (jf, carry_flat(jf)), "ivf_pq": (jp, carry_pq(jp)),
            "ivf_bq": (jb, carry_bq(jb))}


def _cagra_pair(data):
    """A JAX CagraIndex with every payload array (random contents, the
    build's shapes and dtypes) and its port copy: the layout is all the
    cost model reads."""
    import jax.numpy as jnp

    X, _ = data
    rng = np.random.default_rng(11)
    n, dim, deg, p, c = X.shape[0], X.shape[1], 8, 4, 16
    arrays = {
        "dataset": X, "graph": rng.integers(0, n, (n, deg)).astype(np.int32),
        "norms": (X ** 2).sum(1).astype(np.float32),
        "proj": rng.standard_normal((dim, p)).astype(np.float32),
        "code_scale": np.float32(0.5),
        "nbr_codes": rng.integers(-127, 127, (n, deg, p)).astype(np.int8),
        "centroids": rng.standard_normal((c, dim)).astype(np.float32),
        "centroid_reps": rng.integers(0, n, c).astype(np.int32),
        "proj_energy": np.float32(0.9)}
    jidx = jcg.CagraIndex(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jidx, tcg.from_jax_arrays({"kind": "cagra"}, arrays, device=CPU)


def _pair(kind, data, built):
    X, _ = data
    if kind in built:
        return built[kind]
    if kind == "brute_force":
        return (jbf.build(X, metric="sqeuclidean"),
                tbf.build(X, metric="sqeuclidean", device=CPU))
    if kind == "cagra":
        return _cagra_pair(data)
    fam = {"paged_flat": "ivf_flat", "paged_pq": "ivf_pq",
           "paged_bq": "ivf_bq"}[kind]
    j, t = built[fam]
    return (jsv.PagedListStore.from_index(j, page_rows=32),
            tsv.PagedListStore.from_index(t, page_rows=32, device=CPU))


# ---------------------------------------------------------------------------
# predict_index_bytes: the JAX formula, exact against the port's objects
# ---------------------------------------------------------------------------


def _layout_draw(kind, rng):
    i = lambda lo, hi: int(rng.integers(lo, hi))  # noqa: E731
    dim = i(8, 200)
    if kind == "brute_force":
        return dict(n=i(1, 10 ** 6), dim=dim,
                    dtype=str(rng.choice(["float32", "uint8", "int8"])),
                    norms=bool(rng.integers(2)))
    if kind == "ivf_flat":
        return dict(n_lists=i(1, 4096), dim=dim, max_list_size=i(1, 8192),
                    dtype=str(rng.choice(["float32", "uint8"])),
                    norms=bool(rng.integers(2)),
                    plan_cache=bool(rng.integers(2)))
    if kind == "ivf_pq":
        pq_dim = int(rng.choice([4, 8, 16, 32]))
        return dict(n_lists=i(1, 4096), dim=dim, max_list_size=i(1, 8192),
                    pq_dim=pq_dim, pq_bits=int(rng.choice([4, 5, 8])),
                    codebook_kind=str(rng.choice(["subspace", "cluster"])),
                    decoded=bool(rng.integers(2)),
                    plan_cache=bool(rng.integers(2)))
    if kind == "ivf_bq":
        return dict(n_lists=i(1, 4096), dim=dim, max_list_size=i(1, 8192),
                    bits=i(1, 5),
                    rotation_kind=str(rng.choice(["dense", "hadamard"])),
                    plan_cache=bool(rng.integers(2)))
    if kind == "cagra":
        return dict(n=i(1, 10 ** 6), dim=dim, graph_degree=i(8, 128),
                    dtype=str(rng.choice(["float32", "uint8"])),
                    proj_dim=int(rng.choice([0, 16, 32])),
                    n_centroids=int(rng.choice([0, 64, 1024])))
    store_kind = str(rng.choice(["ivf_flat", "ivf_pq", "ivf_bq"]))
    return dict(n_lists=i(1, 4096), dim=dim, capacity_pages=i(8, 1 << 16),
                page_rows=int(rng.choice([8, 32, 128])),
                table_width=int(rng.choice([4, 8, 64])),
                payload_width=i(1, 256),
                payload_dtype=str(rng.choice(["float32", "uint8"])),
                store_kind=store_kind, pq_dim=8, pq_bits=8,
                paged_plan_cache=bool(rng.integers(2)))


@pytest.mark.parametrize("draw", range(3))
@pytest.mark.parametrize("kind", ["brute_force", "ivf_flat", "ivf_pq",
                                  "ivf_bq", "cagra", "paged_store"])
def test_predict_index_bytes_equals_jax_on_layout_draws(kind, draw):
    layout = _layout_draw(kind, np.random.default_rng(100 * draw + len(kind)))
    assert tcm.predict_index_bytes(kind, **layout) == \
        jcm.predict_index_bytes(kind, **layout)


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq", "ivf_bq",
                                  "brute_force", "cagra", "paged_flat",
                                  "paged_pq", "paged_bq"])
def test_layout_equals_jax_and_prediction_is_exact(kind, data, built):
    """On each port object carried from a JAX one, ``index_layout`` equals
    JAX's and the prediction equals ``memory.index_bytes`` — before and
    after a search (which attaches the plan caches the formula counts)."""
    j, t = _pair(kind, data, built)
    X, Q = data
    assert tcm.index_layout(t) == jcm.index_layout(j)
    if kind.startswith("paged"):
        # the formula counts the device table mirror a search builds (and
        # the chain-length mirror of the paged kernels, which the port's
        # search builds and JAX's gather scan on the CPU does not)
        tsv.search(t, Q, 5, n_probes=4, device=CPU)
    assert tcm.predict_index_bytes(**tcm.index_layout(t)) == \
        tmem.index_bytes(t)
    if kind in ("ivf_flat", "ivf_pq"):
        {"ivf_flat": tfl, "ivf_pq": tpq}[kind].search(
            t, Q, 5, n_probes=4, backend="ragged", device=CPU)
        assert tcm.index_layout(t)["plan_cache"]
    elif kind == "ivf_bq":
        tbq.search(t, Q, 5, n_probes=4, device=CPU)
    assert tcm.predict_index_bytes(**tcm.index_layout(t)) == \
        tmem.index_bytes(t)


def test_paged_store_exact_after_upserts_and_growth(data, built):
    X, Q = data
    store = tsv.PagedListStore.from_index(built["ivf_pq"][1], page_rows=32,
                                          device=CPU)
    store.upsert(X[:700] + 1.0, np.arange(50_000, 50_700))
    store.delete(np.arange(100))
    tsv.search(store, Q, 5, n_probes=4, device=CPU)
    assert store.growth_events > 0
    assert tcm.predict_index_bytes(**tcm.index_layout(store)) == \
        tmem.index_bytes(store)


# ---------------------------------------------------------------------------
# estimate, admission
# ---------------------------------------------------------------------------

_WS = 1 << 22
_ESTIMATE_CASES = {
    "ivf_flat.search": dict(q=64, dim=32, n_lists=16, max_list_size=128,
                            n_probes=8, k=10, dtype="uint8"),
    "ivf_flat.paged_scan": dict(q=64, dim=32, n_lists=16, capacity_pages=64,
                                page_rows=32, table_width=8, n_probes=8,
                                k=10),
    "ivf_pq.search": dict(q=100, dim=32, n_lists=16, max_list_size=512,
                          pq_dim=8, n_probes=4, k=10),
    "ivf_pq.paged_scan": dict(q=100, dim=32, n_lists=16, capacity_pages=64,
                              page_rows=32, table_width=8, pq_dim=8,
                              n_probes=4, k=10),
    "ivf_bq.search": dict(q=100, dim=40, n_lists=16, max_list_size=512,
                          n_probes=4, k=10, bits=2,
                          rotation_kind="hadamard"),
    "ivf_bq.paged_scan": dict(q=100, dim=40, n_lists=16, capacity_pages=64,
                              page_rows=32, table_width=8, n_probes=4, k=10),
    "brute_force.search": dict(q=50, n=100_000, dim=32, k=10),
    "serving.upsert": dict(n_rows=100, payload_width=32, dim=32,
                           payload_dtype="uint8", extra_row_bytes=4),
}


@pytest.mark.parametrize("entry", sorted(_ESTIMATE_CASES))
def test_estimate_equals_jax(entry):
    shapes = dict(_ESTIMATE_CASES[entry], workspace_bytes=_WS)
    assert tcm.estimate(entry, **shapes) == jcm.estimate(entry, **shapes)
    assert sorted(tcm._ESTIMATORS) == sorted(_ESTIMATE_CASES)


def test_estimate_search_from_live_store(data, built):
    _, t = built["ivf_flat"]
    store = tsv.PagedListStore.from_index(t, page_rows=32, device=CPU)
    est = tcm.estimate_search(store, q=8, k=5, n_probes=4)
    assert est["entry"] == "ivf_flat.paged_scan"
    assert est["operand_bytes"] >= store.pages.nbytes
    cost = tcm.paged_scan_estimator(store, 5, 4)
    assert cost(8) == est


def _fake_sample(monkeypatch, mod, in_use=1000):
    monkeypatch.setattr(
        mod.obs_memory, "sample",
        lambda tag: {"source": "test", "bytes_in_use": in_use,
                     "peak_bytes_in_use": in_use})


@pytest.mark.parametrize("pred,verdict", [(100, "admit"), (89_000, "queue"),
                                          (99_000, "reject")])
def test_admission_verdicts_equal_jax(monkeypatch, pred, verdict):
    recs = []
    for mod in (tcm, jcm):
        _fake_sample(monkeypatch, mod)
        recs.append(mod.check_admission(pred, entry="t",
                                        budget_bytes=100_000))
    for rec in recs:
        rec.pop("t")
    assert recs[0] == recs[1]
    assert recs[0]["verdict"] == verdict
    assert recs[0]["budget_source"] == "caller"


def test_admission_env_budget_and_event(monkeypatch):
    tres.clear_events()
    tobs.enable()
    monkeypatch.setenv(tcm.HBM_ENV, "1000")
    rec = tcm.check_admission(10_000_000, entry="env_t")
    assert rec["verdict"] == tcm.REJECT and rec["budget_source"] == "env"
    assert rec["shortfall_bytes"] > 0
    evs = [e for e in tres.recent_events()
           if e.get("event") == "admission_reject"]
    assert evs and evs[-1]["entry"] == "env_t"
    assert tcm.admission_counts(tobs.snapshot()["counters"]) == {"reject": 1}


def test_admission_unknown_budget_admits(monkeypatch):
    monkeypatch.setattr(tcm, "hbm_budget",
                        lambda: {"bytes": 0, "source": "unknown"})
    rec = tcm.check_admission(1 << 40, entry="t")
    assert rec["verdict"] == tcm.ADMIT and rec["projected_fraction"] is None


def test_admission_never_raises(monkeypatch):
    def boom(tag):
        raise RuntimeError("sampler down")

    monkeypatch.setattr(tcm.obs_memory, "sample", boom)
    rec = tcm.check_admission(123, entry="t")
    assert rec["verdict"] == tcm.ADMIT and rec["budget_source"] == "unknown"
    rec = tcm.check_admission(object(), entry="garbage")
    assert rec["verdict"] == tcm.ADMIT and rec["predicted_bytes"] == 0
    assert any(e.get("event") == "admission_bad_prediction"
               for e in tres.recent_events())


def test_admission_worst_card_wins(monkeypatch):
    hot = {"device": "0", "platform": "gpu", "bytes_in_use": 95,
           "peak_bytes_in_use": 95, "bytes_limit": 100}
    cold = [{"device": str(i), "platform": "gpu", "bytes_in_use": 1,
             "peak_bytes_in_use": 1, "bytes_limit": 100} for i in range(1, 8)]
    monkeypatch.setattr(
        tcm.obs_memory, "sample",
        lambda tag: {"source": "device_stats", "bytes_in_use": 102,
                     "peak_bytes_in_use": 102, "per_device": [hot] + cold})
    monkeypatch.setattr(tcm, "hbm_budget",
                        lambda: {"bytes": 800, "source": "device_stats"})
    rec = tcm.check_admission(10, entry="t")
    assert rec["verdict"] == tcm.REJECT and rec["projected_fraction"] == 1.05


def test_hbm_budget_reads_the_cards_total(monkeypatch):
    monkeypatch.setattr(
        tmem, "device_stats",
        lambda: [{"device": "0", "platform": "gpu", "bytes_in_use": 5,
                  "peak_bytes_in_use": 5, "bytes_limit": 80 << 30}])
    assert tcm.hbm_budget() == {"bytes": 80 << 30, "source": "device_stats"}
    monkeypatch.setenv(tcm.HBM_ENV, "12345")
    assert tcm.hbm_budget() == {"bytes": 12345, "source": "env"}


def test_xla_analyses_return_none_classified():
    tres.clear_events()
    assert tcm.xla_memory_analysis(None) is None
    assert trl.xla_cost_analysis(None) is None
    names = [e.get("event") for e in tres.recent_events()]
    assert "costmodel_xla_analysis_unavailable" in names
    assert "roofline_xla_analysis_unavailable" in names


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

_FLOP_CASES = {
    "brute_force.search": dict(q=64, n=50_000, dim=32, k=10),
    "ivf_flat.search": dict(q=1000, dim=128, n_lists=1024,
                            max_list_size=2048, n_probes=16, k=10,
                            dtype="uint8"),
    "ivf_flat.paged_scan": dict(q=100, dim=128, n_lists=64, page_rows=128,
                                table_width=16, n_probes=8, k=10,
                                dtype="uint8"),
    "ivf_flat.paged_pallas": dict(q=10_000, dim=128, n_lists=1024,
                                  page_rows=128, table_width=32,
                                  n_probes=16, k=10, dtype="uint8"),
    "ivf_pq.search": dict(q=10_000, dim=128, n_lists=1024,
                          max_list_size=2048, pq_dim=64, n_probes=16, k=20),
    "ivf_pq.paged_scan": dict(q=100, dim=128, n_lists=64, page_rows=128,
                              table_width=16, pq_dim=64, n_probes=8, k=10),
    "ivf_pq.paged_pallas": dict(q=10_000, dim=128, n_lists=1024,
                                page_rows=128, table_width=32, pq_dim=64,
                                n_probes=16, k=20),
    "ivf_bq.search": dict(q=10_000, dim=100, n_lists=1024,
                          max_list_size=2048, n_probes=256, k=80, bits=2,
                          rotation_kind="hadamard"),
    "ivf_bq.paged_pallas": dict(q=10_000, dim=128, n_lists=1024,
                                page_rows=128, table_width=32,
                                n_probes=256, k=80),
    "cagra.fused_hop": dict(q=10_000, width=4, degree=32, proj_dim=32,
                            itopk=64, hops=1),
    "serving.scatter": dict(n_rows=100, dim=128, payload_width=128,
                            payload_dtype="uint8", extra_row_bytes=4),
    "serving.maintenance.reencode": dict(n_rows=5000, dim=128, rot_dim=128,
                                         pq_dim=64, n_codes=256),
    "linalg.srht_apply": dict(n=10_000, rot_dim=128),
    "ivf_flat.build": dict(n=100_000, dim=128, n_lists=1024),
    "ivf_pq.build": dict(n=100_000, dim=128, n_lists=1024, pq_dim=64),
    "ivf_bq.build": dict(n=100_000, dim=128, n_lists=1024, bits=3,
                         rotation_kind="hadamard"),
}


@pytest.mark.parametrize("entry", sorted(_FLOP_CASES))
def test_estimate_flops_equals_jax(entry):
    assert trl.estimate_flops(entry, **_FLOP_CASES[entry]) == \
        jrl.estimate_flops(entry, **_FLOP_CASES[entry])
    assert sorted(trl._MODELS) == sorted(_FLOP_CASES)
    assert trl._SPAN_OF == jrl._SPAN_OF


@pytest.mark.parametrize("name,flops,bw", [
    ("NVIDIA H100 PCIe", 756e12, 2.0e12),
    ("NVIDIA H100 NVL", 835e12, 3.9e12),
    ("NVIDIA H100 80GB HBM3", 989e12, 3.35e12)])
def test_platform_peaks_of_the_h100_cards(monkeypatch, name, flops, bw):
    monkeypatch.setattr(trl, "_device_kind", lambda: name)
    assert trl.platform_peaks() == {"peak_flops": flops, "peak_bw": bw,
                                    "source": "table", "device_kind": name}


def test_platform_peaks_env_both_or_neither(monkeypatch):
    monkeypatch.setattr(trl, "_device_kind", lambda: "NVIDIA H100 80GB HBM3")
    monkeypatch.setenv(trl.PEAK_FLOPS_ENV, "1e12")
    assert trl.platform_peaks()["source"] == "table"     # partial: ignored
    monkeypatch.setenv(trl.PEAK_BW_ENV, "2e11")
    peaks = trl.platform_peaks()
    assert (peaks["peak_flops"], peaks["peak_bw"], peaks["source"]) == \
        (1e12, 2e11, "env")
    monkeypatch.setattr(trl, "_device_kind", lambda: "")
    monkeypatch.delenv(trl.PEAK_FLOPS_ENV)
    assert trl.platform_peaks()["source"] == "unknown"


@pytest.mark.parametrize("entry", ["ivf_flat.paged_pallas", "ivf_pq.search",
                                   "cagra.fused_hop", "serving.scatter"])
def test_utilization_equals_jax(monkeypatch, entry):
    monkeypatch.setenv(trl.PEAK_FLOPS_ENV, "989e12")
    monkeypatch.setenv(trl.PEAK_BW_ENV, "3.35e12")
    monkeypatch.setattr(trl, "_device_kind", lambda: "")
    monkeypatch.setattr(jrl, "_device_kind", lambda: "")
    for measured in (None, 1.7e-3):
        got = trl.utilization(entry, measured_s=measured,
                              **_FLOP_CASES[entry])
        want = jrl.utilization(entry, measured_s=measured,
                               **_FLOP_CASES[entry])
        assert got == want


def test_summary_folds_notes_against_dispatch_histograms(monkeypatch):
    """Both packages, the same notes and the same committed durations in
    the ``dispatch.<span>`` histogram: the same window-mean roofline."""
    monkeypatch.setenv(trl.PEAK_FLOPS_ENV, "989e12")
    monkeypatch.setenv(trl.PEAK_BW_ENV, "3.35e12")
    rows = []
    for ob, rl in ((tobs, trl), (jobs, jrl)):
        ob.enable()
        for q, dt in ((10_000, 2.0e-3), (5_000, 1.5e-3)):
            rl.note_dispatch("ivf_flat.paged_pallas",
                             dict(_FLOP_CASES["ivf_flat.paged_pallas"], q=q))
            ob.observe("dispatch.ivf_flat::paged_pallas", dt)
        rows.append(rl.summary()["entries"]["ivf_flat.paged_pallas"])
    for key in ("flops", "bytes", "measured_s", "predicted_bound_s",
                "mxu_utilization", "hbm_bw_utilization", "model_to_measured",
                "bound", "dispatches"):
        assert rows[0][key] == rows[1][key], key
    assert rows[0]["model_to_measured"] <= 1.0


def test_sync_spans_fold_into_dispatch_histograms(monkeypatch):
    """A registered dispatch span in sync mode folds its committed time
    into ``dispatch.<span>``; an unregistered one does not."""
    monkeypatch.setattr(tobs.tracing, "drain_device", lambda: True)
    tobs.enable()
    tobs.enable_sync()
    with tobs.record_span("ivf_flat::paged_pallas"):
        pass
    with tobs.record_span("host::thing"):
        pass
    hists = tobs.snapshot()["histograms"]
    assert hists["dispatch.ivf_flat::paged_pallas"]["count"] == 1
    assert "dispatch.host::thing" not in hists
    assert trl.dispatch_histogram("ivf_flat.paged_pallas")["count"] == 1


def test_search_notes_land_in_the_roofline(data, built):
    """With telemetry on, each family's search notes its JAX entry, with
    the planner's occupancy where the host holds the list lengths."""
    X, Q = data
    tobs.enable()
    _, f = built["ivf_flat"]
    tfl.search(f, Q, 5, n_probes=4, backend="ragged", device=CPU)
    tfl.search(f, Q, 5, n_probes=4, backend="ragged", device=CPU)
    store = tsv.PagedListStore.from_index(f, page_rows=32, device=CPU)
    tsv.search(store, Q, 5, n_probes=4, device=CPU)
    store.upsert(X[:10], np.arange(70_000, 70_010))
    tbq.search(built["ivf_bq"][1], Q, 5, n_probes=4, device=CPU)
    ents = trl.entries()
    assert ents["ivf_flat.search"]["count"] == 2
    assert "padded_row_fraction" in ents["ivf_flat.search"]["occupancy"]
    assert "page_fill" in ents["ivf_flat.paged_pallas"]["occupancy"]
    assert ents["ivf_bq.search"]["count"] == 1
    assert ents["serving.scatter"]["est"]["flops"] == 0


# ---------------------------------------------------------------------------
# compile ledger
# ---------------------------------------------------------------------------


def _grow(store, rng_seed, start_id):
    """Upsert 128-row batches until the store's capacity grows; the same
    rows and ids for both packages."""
    rng = np.random.default_rng(rng_seed)
    g0, nid = store.growth_events, start_id
    while store.growth_events == g0:
        store.upsert(rng.standard_normal((128, 16)).astype(np.float32),
                     np.arange(nid, nid + 128))
        nid += 128


def test_growth_record_names_the_table_as_jax_does(data, built):
    X, Q = data
    jf, tf = built["ivf_flat"]
    recs = []
    for sv, idx, kw, ledger in (
            (jsv, jf, {}, jcomp),
            (tsv, tf, {"backend": "gather", "device": CPU}, tcomp)):
        store = sv.PagedListStore.from_index(
            idx, page_rows=32, **({"device": CPU} if sv is tsv else {}))
        sv.search(store, Q[:4], 3, n_probes=4, **kw)
        n0 = len(ledger.ledger(entry="ivf_flat.paged_scan"))
        _grow(store, 5, 5_000_000)
        sv.search(store, Q[:4], 3, n_probes=4, **kw)
        new = ledger.ledger(entry="ivf_flat.paged_scan")[n0:]
        assert len(new) == 1 and not new[0]["first"]
        recs.append(new[0]["changed"])
    assert recs[0] == recs[1]
    assert "table" in {c["operand"] for c in recs[1]}


def test_steady_window_records_nothing(data, built):
    X, Q = data
    store = tsv.PagedListStore.from_index(built["ivf_flat"][1], page_rows=32,
                                          device=CPU)
    store.reserve(2000)
    tsv.search(store, Q[:4], 3, n_probes=4, device=CPU)
    t0, u0 = tsv.scan_trace_count(), tcomp.unexplained_retraces()
    rng = np.random.default_rng(3)
    for s in range(3):
        store.upsert(rng.standard_normal((100, 16)).astype(np.float32),
                     np.arange(9_000_000 + 100 * s, 9_000_100 + 100 * s))
        tsv.search(store, Q[:4], 3, n_probes=4, device=CPU)
    assert tsv.scan_trace_count() == t0
    assert tcomp.unexplained_retraces() == u0


def test_new_static_is_attributed(data, built):
    X, Q = data
    store = tsv.PagedListStore.from_index(built["ivf_flat"][1], page_rows=32,
                                          device=CPU)
    tsv.search(store, Q[:4], 3, n_probes=4, device=CPU)
    n0 = len(tcomp.ledger(entry="ivf_flat.paged_pallas"))
    tsv.search(store, Q[:4], 3, n_probes=2, device=CPU)
    new = tcomp.ledger(entry="ivf_flat.paged_pallas")[n0:]
    assert len(new) == 1
    assert any(c["operand"] == "static.n_probes" for c in new[0]["changed"])


def test_a_met_signature_records_nothing():
    x = np.zeros(3)
    c0, u0 = tcomp.trace_count("test.met"), tcomp.unexplained_retraces()
    tcomp.trace_event("test.met", x=x)
    tcomp.trace_event("test.met", x=x)
    tcomp.trace_event("test.met", x=torch.zeros(3, dtype=torch.float64))
    assert tcomp.trace_count("test.met") - c0 == 1
    assert tcomp.unexplained_retraces() == u0
    assert tcomp.ledger(entry="test.met")[-1]["shapes"]["x"] == "float64[3]"


def test_watch_stamps_own_thread_only():
    tcomp.trace_event("test.thread_a", static={"i": 0})
    with tcomp.watch():
        t = threading.Thread(target=lambda: tcomp.trace_event(
            "test.thread_b", static={"i": 0}))
        t.start()
        t.join()
        tcomp.trace_event("test.thread_a", static={"i": 1})
    assert "wall_s" not in tcomp.ledger(entry="test.thread_b")[-1]
    assert tcomp.ledger(entry="test.thread_a")[-1].get("wall_s", 0) > 0


def test_ledger_cap_bounds_the_ring_and_counts_survive():
    before = tcomp.trace_count("test.cap_entry")
    tcomp.set_ledger_cap(4)
    try:
        for i in range(10):
            tcomp.trace_event("test.cap_entry", static={"i": i})
        assert len(tcomp.ledger(entry="test.cap_entry")) <= 4
        assert tcomp.trace_count("test.cap_entry") - before == 10
        with tcomp.watch():
            tcomp.trace_event("test.cap_entry", static={"i": 10})
        assert tcomp.ledger(entry="test.cap_entry")[-1].get("wall_s", 0) > 0
    finally:
        tcomp.set_ledger_cap(512)


def test_a_library_loaded_twice_is_an_unexplained_retrace(monkeypatch,
                                                          tmp_path):
    lib = tmp_path / "libfake.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(_native, "library_path", lambda source: lib)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_native, "_loaded", {})
    u0 = tcomp.unexplained_retraces()
    c0 = tcomp.trace_count("native.strip_scan")
    _native.load("strip_scan")
    _native.load("strip_scan")                     # cached: no new load
    assert tcomp.unexplained_retraces() == u0
    _native._loaded.clear()
    _native.load("strip_scan")                     # the same hash again
    assert tcomp.trace_count("native.strip_scan") - c0 == 2
    assert tcomp.unexplained_retraces() - u0 == 1
    rec = tcomp.ledger(entry="native.strip_scan")[-1]
    assert rec["unexplained"] and rec["shapes"]["static.library"] == \
        "'libfake.so'" and rec["wall_s"] >= 0
    tcomp.reset()


def test_summary_shape():
    tcomp.trace_event("test.summary", static={"i": 0})
    s = tcomp.summary(recent=2)
    assert set(s) == {"total_traces", "entries", "unexplained_retraces",
                      "recent"}
    assert s["total_traces"] == sum(s["entries"].values())
    assert len(s["recent"]) <= 2 and tcomp.summary(recent=0)["recent"] == []


def test_scan_trace_count_shims(data, built):
    X, Q = data
    b0 = tbq.scan_trace_count()
    tbq.search(built["ivf_bq"][1], Q[:3], 5, n_probes=3, device=CPU)
    tbq.search(built["ivf_bq"][1], Q[:3], 5, n_probes=3, device=CPU)
    assert tbq.scan_trace_count() - b0 <= 1
    assert tsv.scan_trace_count() == sum(
        tcomp.trace_count(e) for e in
        ("ivf_flat.paged_scan", "ivf_pq.paged_scan", "ivf_flat.paged_pallas",
         "ivf_pq.paged_pallas", "ivf_bq.paged_pallas"))


# ---------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------


def test_live_bytes_counts_a_storage_once():
    tmem.live_bytes()
    base = torch.zeros(1 << 18)                  # 1 MiB
    b1 = tmem.live_bytes()
    views = [base[: 1 << 17], base.view(512, 512)]
    assert tmem.live_bytes() == b1
    del views
    rec = tmem.sample("unit")
    assert rec["source"] == "live_arrays" and rec["bytes_in_use"] >= 1 << 20
    assert tmem.device_stats() == []


def test_record_index_gauge(data, built):
    tobs.enable()
    _, t = built["ivf_flat"]
    b = tmem.record_index("flat", t)
    assert b == tmem.index_bytes(t) > 0
    assert tobs.snapshot()["gauges"]["memory.index.flat.bytes"]["last"]


# ---------------------------------------------------------------------------
# serving.search: the JAX package's span and counter
# ---------------------------------------------------------------------------


def _tree(ob, root_name):
    spans = [s for s in ob.spans()
             if not s["name"].startswith(("obs.roofline::", "obs.costmodel::",
                                          "obs.memory::"))]
    kids = {}
    for s in spans:
        kids.setdefault(s["parent_id"], []).append(s)

    def names_under(sid):
        out = []
        for c in kids.get(sid, []):
            out.append(c["name"])
            out.extend(names_under(c["span_id"]))
        return out

    return [(r["name"], names_under(r["span_id"])) for r in spans
            if r["name"] == root_name]


def test_serving_search_records_span_and_counter_as_jax(data, built):
    X, Q = data
    jf, tf = built["ivf_flat"]
    jstore = jsv.PagedListStore.from_index(jf, page_rows=32)
    tstore = tsv.PagedListStore.from_index(tf, page_rows=32, device=CPU)
    jobs.enable()
    tobs.enable()
    for _ in range(3):
        jsv.search(jstore, Q, 5, n_probes=4)
        tsv.search(tstore, Q, 5, n_probes=4, device=CPU)
    for ob in (jobs, tobs):
        assert ob.snapshot()["counters"]["serving.searches"] == 3
    jt, tt = _tree(jobs, "serving::search"), _tree(tobs, "serving::search")
    assert len(jt) == len(tt) == 3
    for (_, jk), (_, tk) in zip(jt, tt):
        assert jk[0] == tk[0] == "ivf_flat::search_paged"
        assert any(n.startswith("ivf_flat::paged_") for n in jk)
        assert any(n.startswith("ivf_flat::paged_") for n in tk)
