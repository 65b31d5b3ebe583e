"""The port's spans and counters inside the IVF-PQ ragged search, on the
CPU (the strip path runs K1's plain twin there with ``backend="ragged"``).

* one search's span tree: the phase spans under ``ivf_pq::scan``, one
  trace id, the class spans' attributes against the strip plan;
* the work counters against an independent count from the probes, the
  bias and the static plan, with no filter, a filter passing half the
  rows, one passing a tenth and one passing none (under a filter K1's
  gathered walk: its columns are the finite lanes in whole tiles); the
  gathered launches counted under a filter alone;
* telemetry off: no span, no counter, no device mark;
* per-name totals (host and planted device times) exact after the ring
  evicts, and a record's ``device_s`` through the Chrome export;
* a snapshot that resolves only what the card has passed, and the one
  wait (``registry.settle``) that resolves the rest and reads the device
  counters; the roofline's read of the dispatch fold after it.

Imports neither JAX nor the JAX package.
"""

import json
import math

import numpy as np
import pytest
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.neighbors import ivf_bq, ivf_flat, ivf_pq, refine
from raft_tpu_torch.neighbors._filtering import apply_filter_bias, widen_plan
from raft_tpu_torch.obs import tracing
from raft_tpu_torch.obs.registry import add_device, settle
from raft_tpu_torch.ops import strip_scan as ss

CPU = "cpu"
PHASES = {"ivf_pq::probe_select", "ivf_pq::bias", "strip_scan::plan",
          "strip_scan::group", "strip_scan::class", "strip_scan::merge",
          "ivf_pq::finalize"}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setattr(tracing, "_EVENT_POOL", [])
    for fn in (obs.disable, obs.disable_sync, obs.reset, obs.clear_spans):
        fn()
    yield
    for fn in (obs.disable, obs.disable_sync, obs.reset, obs.clear_spans):
        fn()
    tracing.set_ring_cap(4096)


@pytest.fixture(scope="module")
def data():
    g = torch.Generator().manual_seed(3)
    return torch.randn(4000, 32, generator=g), torch.randn(40, 32, generator=g)


@pytest.fixture(scope="module")
def index(data):
    ds, _ = data
    return ivf_pq.build(ds, ivf_pq.IvfPqParams(
        n_lists=8, pq_dim=8, group_size=512, kmeans_n_iters=5), device=CPU)


def search(index, qs, filter=None):
    return ivf_pq.search(index, qs, 10, n_probes=3, backend="ragged",
                         filter=filter, device=CPU)


class Planted:
    """A stand-in CUDA event: every span it brackets reads 1 ms."""

    device = "planted"

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1.0


def test_one_search_is_one_tree_of_phase_spans(data, index):
    _, qs = data
    obs.enable()
    search(index, qs)
    recs = [r for r in obs.spans() if not r["name"].startswith("obs.")]
    by_id = {r["span_id"]: r["name"] for r in recs}
    tree = {(r["name"], by_id.get(r["parent_id"])) for r in recs}
    assert tree == {("ivf_pq::search", None),
                    ("ivf_pq::scan", "ivf_pq::search")} | {
        (name, "ivf_pq::scan") for name in PHASES}
    assert len({r["trace_id"] for r in obs.spans()}) == 1
    classes = [r["attrs"] for r in recs if r["name"] == "strip_scan::class"]
    _, _, _, layout = static_plan_of(index, qs)
    assert [(c["kernel"], c["w_blocks"], c["n_sub"], c["strips"])
            for c in classes] == [("K1", w, n, cnt)
                                  for (w, n, _, cnt) in layout]
    for r in recs:
        if r["name"].startswith("strip_scan::"):
            assert r["attrs"]["kernel"] == "K1"


def test_refine_is_its_own_span(data, index):
    ds, qs = data
    _, cand = search(index, qs)
    obs.enable()
    refine.refine(ds, qs, cand, 5, device=CPU)
    assert [(r["name"], r["parent_id"]) for r in obs.spans()] == [
        ("refine::refine", None)]


def static_plan_of(index, qs, filter=None):
    """The probes, the scan bias and the static plan the search runs,
    rebuilt from the index."""
    n_probes, _, _, _ = widen_plan(filter, 3, index.n_lists)
    probes, _, _ = ivf_pq._pq_probe_prep(qs, index.centers, index.rotation,
                                         n_probes, "exact", True)
    bias = apply_filter_bias(
        ivf_pq._ragged_bias_pq(index.b_sum, index.centers, index.rotation,
                               True), index.list_ids, filter)
    dim = int(index.decoded.shape[-1]) if index.decoded is not None \
        else index.rotation.shape[0]
    classes, class_counts, cls_ord, _ = ivf_pq._ragged_plan_static(
        index, n_probes, 10, ivf_pq.resources_for(CPU, None), dim)
    qids, strip_list, _, _, layout = ss.static_plan(
        probes, cls_ord, classes, class_counts, index.n_lists)(0, qs.shape[0])
    return probes, bias, (qids, strip_list), layout


FILTERS = {"none": None, "half": 0.5, "tenth": 0.1, "nothing": 0.0}


def columns_walked(bias, w, n_sub, gathered):
    """(n_lists,) columns K1 walks over a list's sub-blocks: w a live
    sub-block on the dense walk, the finite lanes in whole 128-column
    tiles on the gathered walk."""
    fin = torch.isfinite(bias[:, :n_sub * w]).reshape(-1, n_sub, w).sum(2)
    if gathered:
        return ((fin + 127) // 128 * 128).sum(dim=1)
    return (fin > 0).sum(dim=1) * w


@pytest.mark.parametrize("which", list(FILTERS))
def test_counters_equal_a_count_from_the_plan_and_the_bias(data, index,
                                                           which):
    _, qs = data
    share = FILTERS[which]
    filt = None
    if share is not None:
        rng = np.random.default_rng(11)
        filt = Bitset.from_mask(rng.random(4000) < share, device=CPU)
    search(index, qs, filt)          # the decoded cache is built once
    obs.enable()
    search(index, qs, filt)
    settle()
    got = obs.snapshot()["counters"]
    probes, bias, (qids, strip_list), layout = static_plan_of(index, qs, filt)
    gathered = filt is not None
    fin = torch.isfinite(bias).sum(dim=1)
    needed = int(fin[probes.long()].sum())
    rows = (qids >= 0).sum(dim=1).tolist()
    computed = 0
    for (w_blocks, n_sub, start, count) in layout:
        w = w_blocks * ss.MC
        assert ss.k1_block_rows(CPU, qs.shape[1], bias.shape[1], w, n_sub,
                                10, False, gathered) == 32
        cols = columns_walked(bias, w, n_sub, gathered)
        for s in range(start, start + count):
            lst = int(strip_list[s])
            if lst >= 0 and rows[s] > 0:
                computed += math.ceil(rows[s] / 32) * 32 * int(cols[lst])
    assert got["strip_scan.k1.products_needed"] == needed
    assert got["strip_scan.k1.products_computed"] == computed
    assert got["strip_scan.slots.launched"] == ss.C * sum(
        cnt for (_, _, _, cnt) in layout)
    assert got["strip_scan.slots.live"] == probes.numel()
    assert "strip_scan.k1.launches" not in got     # the twin launches none
    assert "strip_scan.k1.by_id_launches" not in got
    assert "strip_scan.k1.gathered_launches" not in got
    if which == "nothing":
        assert needed == 0 and computed == 0
    else:
        assert 0 < needed < computed
    if filt is not None:
        (scan,) = [r for r in obs.spans() if r["name"] == "ivf_pq::scan"]
        assert scan["attrs"]["filter_n_probes"] == probes.shape[1]
        assert "filter_widen_x" in scan["attrs"]
    assert "ivf_pq.search.rows_scanned" not in got


def launching_twin(monkeypatch):
    """``strip_class`` on the CPU counting launches as the card's wrapper
    does (all, by id, gathered), so the engine's launch counters read the
    search's class calls."""
    real = ss.strip_class

    def counted(*args, qids=None, gathered=False, **kw):
        out = real(*args, qids=qids, gathered=gathered, **kw)
        ss.STRIP_KERNEL.launches += 1
        ss.STRIP_KERNEL_BY_ID.launches += qids is not None
        ss.STRIP_KERNEL_GATHERED.launches += gathered
        return out

    monkeypatch.setattr(ss, "strip_class", counted)


@pytest.mark.parametrize("share", [None, 0.1, 0.6])
def test_gathered_launches_count_every_filtered_launch(
        data, index, monkeypatch, share):
    """A traced search counts every K1 launch as gathered under a filter,
    passing a tenth of the rows or 60% of them, and none without a
    filter."""
    _, qs = data
    filt = None
    if share is not None:
        mask = np.zeros(4000, bool)
        mask[np.random.default_rng(4).permutation(4000)[:int(share * 4000)]] \
            = True
        filt = Bitset.from_mask(mask, device=CPU)
    launching_twin(monkeypatch)
    search(index, qs, filt)
    obs.enable()
    search(index, qs, filt)
    settle()
    got = obs.snapshot()["counters"]
    assert got["strip_scan.k1.launches"] == got[
        "strip_scan.k1.by_id_launches"] >= 1
    if share is not None:
        assert got["strip_scan.k1.gathered_launches"] == got[
            "strip_scan.k1.launches"]
    else:
        assert "strip_scan.k1.gathered_launches" not in got


def test_telemetry_off_records_no_span_counter_or_mark(data, index,
                                                       monkeypatch):
    _, qs = data
    marks = []
    monkeypatch.setattr(tracing, "device_mark",
                        lambda: marks.append(1) or Planted())
    search(index, qs)
    assert obs.spans() == []
    assert obs.snapshot()["counters"] == {}
    assert marks == [] and tracing.pending_device() == 0
    obs.enable()
    search(index, qs)
    assert len(marks) == 2 * len(obs.spans())


def test_per_name_totals_stay_exact_when_the_ring_evicts(data, index,
                                                         monkeypatch):
    _, qs = data
    monkeypatch.setattr(tracing, "device_mark", lambda: Planted())
    search(index, qs)
    n_classes = len(static_plan_of(index, qs)[3])
    tracing.set_ring_cap(5)
    obs.enable()
    for _ in range(3):
        search(index, qs)
    timers = obs.snapshot()["timers"]
    assert len(obs.spans()) == 5
    assert tracing.pending_device() == 0
    for name in PHASES | {"ivf_pq::search", "ivf_pq::scan"}:
        n = 3 * (n_classes if name == "strip_scan::class" else 1)
        assert timers[name]["count"] == n, name
        assert timers[name]["device_count"] == n
        assert timers[name]["device_total_s"] == pytest.approx(n * 1e-3)
        assert timers[name]["total_s"] > 0


class Running(Planted):
    """A planted event the card has not passed yet."""

    def query(self):
        return False


def test_reset_forgets_the_pending_device_times(monkeypatch):
    monkeypatch.setattr(tracing, "device_mark", lambda: Running())
    obs.enable()
    with obs.record_span("a::b"):
        pass
    assert tracing.pending_device() == 1
    obs.reset()
    assert tracing.pending_device() == 0
    monkeypatch.setattr(tracing, "device_mark", lambda: Planted())
    with obs.record_span("a::b"):
        pass
    timer = obs.snapshot()["timers"]["a::b"]
    assert timer["count"] == 1 and timer["device_count"] == 1


def test_device_s_survives_the_chrome_export(tmp_path):
    rec = {"name": "ivf_pq::search", "trace_id": "t", "span_id": "s",
           "parent_id": None, "t0": 1_760_000_000.25, "dur_s": 0.5,
           "tid": 1, "device_s": 0.375}
    tracing.push_span(rec)
    tracing.export_chrome_trace(tmp_path / "t.json")
    (ev,) = [e for e in json.loads((tmp_path / "t.json").read_text())[
        "traceEvents"] if e["cat"] == "span"]
    assert ev["args"]["device_s"] == 0.375
    assert ev["ts"] == 1_760_000_000.25e6 and ev["dur"] == 0.5e6


@pytest.mark.parametrize("family", ["ivf_flat", "ivf_bq"])
def test_shared_engine_spans_name_their_kernel(data, family):
    ds, qs = data
    if family == "ivf_flat":
        idx = ivf_flat.build(ds, ivf_flat.IvfFlatParams(
            n_lists=8, group_size=512, kmeans_n_iters=3), device=CPU)
        run = lambda: ivf_flat.search(idx, qs, 5, n_probes=2,  # noqa: E731
                                      backend="ragged", device=CPU)
        kernel = "K1"
    else:
        idx = ivf_bq.build(ds, ivf_bq.IvfBqParams(n_lists=8,
                                                  kmeans_n_iters=3),
                           device=CPU)
        run = lambda: ivf_bq.search(idx, qs, 5, n_probes=2,  # noqa: E731
                                    device=CPU)
        kernel = "K2"
    obs.enable()
    run()
    recs = obs.spans()
    by_id = {r["span_id"]: r["name"] for r in recs}
    engine = [r for r in recs if r["name"].startswith("strip_scan::")]
    assert {r["name"] for r in engine} == {
        "strip_scan::plan", "strip_scan::group", "strip_scan::class",
        "strip_scan::merge"}
    assert all(r["attrs"]["kernel"] == kernel for r in engine)
    assert {by_id[r["parent_id"]] for r in engine} == {f"{family}::scan"}
    settle()
    counters = obs.snapshot()["counters"]
    for name in ("strip_scan.k1.products_needed", "strip_scan.slots.live",
                 "strip_scan.slots.launched"):
        assert (name in counters) == (kernel == "K1")
    assert not [n for n in counters if n.startswith("strip_scan.k2.")]


@pytest.mark.parametrize("dim,kf,n_sub,tour", [
    (128, 20, 1, False), (1024, 512, 2, False), (3072, 20, 1, True)])
def test_k1_block_rows_off_the_card_are_the_full_block(dim, kf, n_sub, tour):
    """The plain twin has no launch plan: every shape counts K1's largest
    block (the card asks ``plan_launch``; tests/test_torch_obs_search_card.py)."""
    assert ss.k1_block_rows(CPU, dim, 8192, 1024, n_sub, kf, tour) == \
        ss.K1_BLOCK_ROWS == 32


class Later(Planted):
    """A planted event the card passes only once it is waited on."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


def test_snapshot_resolves_only_what_the_card_has_passed(monkeypatch):
    marks = []
    monkeypatch.setattr(tracing, "device_mark",
                        lambda: marks.append(Later()) or marks[-1])
    obs.enable()
    with obs.record_span("a::b"):
        pass
    timer = obs.snapshot()["timers"]["a::b"]
    assert "device_count" not in timer and tracing.pending_device() == 1
    settle()
    assert tracing.pending_device() == 0
    timer = obs.snapshot()["timers"]["a::b"]
    assert timer["device_count"] == 1
    assert timer["device_total_s"] == pytest.approx(1e-3)


def test_device_counters_reach_the_host_at_settle():
    obs.enable()
    add_device("d.n", torch.tensor(3))
    add_device("d.n", torch.tensor(4))
    obs.add("d.n", 1)
    assert obs.snapshot()["counters"] == {"d.n": 1}
    settle()
    assert obs.snapshot()["counters"] == {"d.n": 8}
    settle()                  # each device value is read once
    add_device("d.n", torch.tensor(2))
    settle()
    assert obs.snapshot()["counters"] == {"d.n": 10}


def test_roofline_reads_the_dispatch_fold_after_settling(monkeypatch):
    from raft_tpu_torch.obs import roofline

    monkeypatch.setattr(tracing, "device_mark", lambda: Later())
    monkeypatch.setattr(tracing, "drain_device", lambda: True)
    obs.enable()
    obs.enable_sync()
    with obs.record_span("ivf_flat::scan"):
        pass
    assert "dispatch.ivf_flat::scan" not in obs.snapshot()["histograms"]
    hist = roofline.dispatch_histogram("ivf_flat.search")
    assert hist["count"] == 1 and hist["sum"] == pytest.approx(1e-3)
