"""Port parity: raft_tpu_torch.obs (registry, tracing, aggregate's
percentile bounds, health probe, core/trace) against raft_tpu.obs on the
same sequences.

Both packages get the same calls — counters, timings, histogram
observations, gauges, nested spans, a span that raises — and their
snapshots (keys, counter values, histogram buckets and bounds, gauge
values), span trees (names and parenting) and Chrome traces are held
against each other. Wall-clock durations differ and are not compared.
The health probe is run on the CPU and with a child that sleeps past the
timeout, which both packages must cut off within their bound.
"""

import json
import sys
import time

import numpy as np
import pytest

from raft_tpu import obs as jobs
from raft_tpu import resilience as jres
from raft_tpu.core import trace as jtrace
from raft_tpu.obs import aggregate as jagg
from raft_tpu.obs import health as jhealth
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import resilience as tres
from raft_tpu_torch.core import trace as ttrace
from raft_tpu_torch.obs import aggregate as tagg
from raft_tpu_torch.obs import health as thealth
from raft_tpu_torch.obs import tracing as ttracing


@pytest.fixture(autouse=True)
def _clean_state():
    for ob, res in ((jobs, jres), (tobs, tres)):
        ob.disable()
        ob.disable_sync()
        ob.reset()
        ob.clear_spans()
        res.clear_events()
    yield
    for ob in (jobs, tobs):
        ob.disable()
        ob.disable_sync()
        ob.reset()
        ob.clear_spans()


@pytest.mark.parametrize("seed", range(6))
def test_percentile_bounds_match_jax(seed):
    rng = np.random.default_rng(seed)
    n_keys = int(rng.integers(1, 12))
    exps = rng.choice(np.arange(-20, 22), size=n_keys, replace=False)
    buckets = {f"le_{2.0 ** int(e)!r}": int(rng.integers(1, 50))
               for e in exps}
    if seed == 0:
        buckets["le_0.0"] = 3
        buckets["junk"] = 5
    count = sum(v for k, v in buckets.items() if k != "junk")
    assert tagg.percentile_bounds(buckets, count) == \
        jagg.percentile_bounds(buckets, count)
    assert tagg.QUANTILES == jagg.QUANTILES
    assert tagg.percentile_bounds({}, 0) == jagg.percentile_bounds({}, 0) == {}


def _drive(ob, res):
    """The same telemetry sequence, any package."""
    ob.enable()
    ob.add("a.count")
    ob.add("a.count", 4)
    ob.add("b.rows", 2.5)
    for v in (0.0, 0.3, 1.0, 3.0, 900.0, 2.0 ** 21, 1e-9):
        ob.observe("lat_s", v)
    ob.record_timing("t.phase", 0.25)
    ob.record_timing("t.phase", 0.75)
    ob.set_gauge("g.depth", 5)
    ob.inc_gauge("g.depth", -2)
    ob.inc_gauge("g.new")
    with ob.record_span("root", attrs={"rows": 3}):
        with ob.record_span("child.a") as sp:
            sp.set_attr("probes", 7)
            with ob.record_span("leaf"):
                ob.observe("in_span", 1.5)
        with ob.record_span("child.b"):
            pass
    with pytest.raises(MemoryError):
        with ob.record_span("failing"):
            raise MemoryError()
    with pytest.raises(ValueError):
        with ob.record_span("buggy"):
            raise ValueError("bug")
    ob.disable()
    ob.add("ignored")
    with ob.record_span("ignored.span"):
        pass
    return ob.snapshot(), ob.spans()


def _tree(spans):
    by_id = {s["span_id"]: s for s in spans}
    out = set()
    for s in spans:
        parent = by_id.get(s["parent_id"])
        out.add((s["name"], parent["name"] if parent else None,
                 s.get("error"), tuple(sorted((s.get("attrs") or {}).items()))))
    return out


def test_snapshot_and_span_tree_match_jax():
    jsnap, jspans = _drive(jobs, jres)
    tsnap, tspans = _drive(tobs, tres)
    assert tsnap.keys() == jsnap.keys()
    assert tsnap["counters"] == jsnap["counters"]
    assert tsnap["counters"]["span.errors.oom"] == 1
    assert tsnap["counters"]["span.errors.fatal"] == 1
    assert tsnap["timers"].keys() == jsnap["timers"].keys()
    for name in tsnap["timers"]:
        assert tsnap["timers"][name]["count"] == jsnap["timers"][name]["count"]
    assert tsnap["timers"]["t.phase"] == jsnap["timers"]["t.phase"]
    assert tsnap["histograms"].keys() == jsnap["histograms"].keys()
    for name, h in tsnap["histograms"].items():
        j = jsnap["histograms"][name]
        for key in ("count", "sum", "min", "max", "buckets", "p50_ub",
                    "p90_ub", "p99_ub"):
            assert h[key] == j[key], (name, key)
        assert len(h.get("exemplars", [])) == len(j.get("exemplars", []))
    assert tsnap["gauges"] == jsnap["gauges"]
    assert _tree(tspans) == _tree(jspans)
    assert len(tspans) == len(jspans) == 6
    assert len({s["trace_id"] for s in tspans if s["name"] != "failing"
                and s["name"] != "buggy"}) == 1


def test_chrome_trace_names_and_parenting_match_jax(tmp_path):
    docs = []
    for ob, res, name in ((jobs, jres, "jax"), (tobs, tres, "port")):
        _drive(ob, res)
        res.record_event("degraded_tile", site="x", from_size=8, to_size=4)
        path = tmp_path / f"{name}.json"
        doc = ob.export_chrome_trace(str(path), extra={"run": "t"})
        assert json.loads(path.read_text()) == doc
        docs.append(doc)

    def shape(doc):
        evs = doc["traceEvents"]
        by_id = {e["args"].get("span_id"): e for e in evs if e["ph"] == "X"}
        rows = sorted((e["name"], e["ph"], e["cat"],
                       by_id[e["args"]["parent_id"]]["name"]
                       if e["args"].get("parent_id") in by_id else None)
                      for e in evs)
        return rows, doc["otherData"], doc["displayTimeUnit"]

    assert shape(docs[1]) == shape(docs[0])


def test_export_jsonl_stamps_and_appends(tmp_path):
    tobs.enable()
    tobs.add("x", 2)
    p = tmp_path / "m" / "obs.jsonl"
    r1 = tobs.export_jsonl(str(p), {"run": "a"})
    tobs.export_jsonl(str(p))
    lines = [json.loads(x) for x in p.read_text().splitlines()]
    assert len(lines) == 2 and lines[0] == r1
    assert (r1["process_index"], r1["process_count"]) == (0, 1)
    assert r1["run"] == "a" and r1["counters"] == {"x": 2}


def test_disabled_span_is_the_shared_noop():
    assert tobs.record_span("x") is tobs.NOOP_SPAN
    with tobs.record_span("x") as sp:
        assert sp.set_attr("k", 1) is sp
    tobs.add("x")
    tobs.observe("h", 1.0)
    tobs.set_gauge("g", 1.0)
    assert tobs.snapshot() == {"counters": {}, "timers": {}, "histograms": {},
                               "gauges": {}}
    assert tobs.spans() == []


def test_sync_mode_without_a_cuda_context_claims_nothing():
    tobs.enable()
    tobs.enable_sync()
    assert tobs.sync_enabled()
    assert ttracing.drain_device() is False
    with tobs.record_span("s"):
        pass
    (rec,) = tobs.spans()
    assert "dispatch_s" not in rec


def test_traced_wraps_in_a_span_only_when_enabled():
    @ttrace.traced("mod::entry")
    def f(x):
        with tobs.record_span("mod::inner"):
            return x + 1

    @jtrace.traced("mod::entry")
    def g(x):
        with jobs.record_span("mod::inner"):
            return x + 1

    assert f(1) == g(1) == 2
    assert tobs.spans() == []
    tobs.enable()
    jobs.enable()
    assert f(2) == g(2) == 3
    assert _tree(tobs.spans()) == _tree(jobs.spans())
    assert f.__name__ == "f"
    with ttrace.trace_range("mod::range"):
        pass
    assert any(s["name"] == "mod::range" for s in tobs.spans())
    tobs.disable()
    n = len(tobs.spans())
    with ttrace.trace_range("mod::off"):
        pass
    assert len(tobs.spans()) == n


def test_ring_cap_keeps_the_newest():
    tobs.enable()
    ttracing.set_ring_cap(3)
    try:
        for i in range(5):
            with tobs.record_span(f"s{i}"):
                pass
        assert [s["name"] for s in tobs.spans()] == ["s2", "s3", "s4"]
    finally:
        ttracing.set_ring_cap(4096)


def test_process_info_env_override(monkeypatch):
    assert tobs.process_info() == (0, 1)
    monkeypatch.setenv("RAFT_TPU_PROCESS_INDEX", "2")
    monkeypatch.setenv("RAFT_TPU_PROCESS_COUNT", "4")
    assert tobs.process_info() == jobs.process_info() == (2, 4)


def test_health_probe_on_the_cpu():
    rep = tobs.probe(platform="cpu", timeout=25)
    assert rep.healthy, rep.reason
    assert rep.backend == "cpu" and rep.reason == ""
    assert rep.elapsed_s <= tobs.MAX_TIMEOUT
    assert thealth._SENTINEL == jhealth._SENTINEL
    assert tobs.MAX_TIMEOUT == jobs.MAX_TIMEOUT


def test_health_probe_bounds_a_hanging_child():
    """Both packages' probes cut a child that sleeps past the timeout off
    within their bound and report it unhealthy."""
    sleeper = "import time; time.sleep(60)\n"
    for probe in (tobs.probe, jobs.probe):
        t0 = time.monotonic()
        rep = probe(platform="default", timeout=1.0, child_code=sleeper)
        assert time.monotonic() - t0 < 10.0
        assert not rep.healthy and "timed out" in rep.reason
    rep = tobs.probe(timeout=1e9, child_code="print('RAFT_TPU_HEALTH_OK x')")
    assert rep.healthy and rep.backend == "x"
    rep = tobs.probe(timeout=5, child_code="import sys; sys.exit(3)")
    assert not rep.healthy and "rc=3" in rep.reason


def test_health_module_entry_point(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["health"])
    assert thealth.main(["--platform", "cpu", "--timeout", "25"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["healthy"] and rep["platform"] == "cpu"
