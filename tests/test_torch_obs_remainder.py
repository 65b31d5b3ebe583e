"""The obs remainder of the port — ``obs/tracing.clock_handshake``,
``bench/progress``, ``obs/aggregate`` (merge, stitch, CLI), ``obs/slo``,
``obs/report``, ``obs/explain``, ``obs/flight`` and the ``obs`` exports —
held against the JAX package.

The functions that are pure over records (explain, the validators, the
frontier, render, fingerprint, the merges and the stitch) must give EQUAL
outputs on the same records, fed both ways: records made by the JAX
package go into the port and records made by the port go into the JAX
package. The SLO engine is driven by one synthetic clock and one scripted
registry stream in both packages and must reach equal burn states. Every
test that enables telemetry or arms a fault resets both packages' state.
"""

import ast
import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu import resilience as jres
from raft_tpu.bench import progress as jprog
from raft_tpu.obs import aggregate as jagg
from raft_tpu.obs import explain as jexp
from raft_tpu.obs import flight as jfl
from raft_tpu.obs import report as jrep
from raft_tpu.obs import slo as jslo
from raft_tpu.obs import tracing as jtr
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import resilience as tres
from raft_tpu_torch.bench import progress as tprog
from raft_tpu_torch.obs import aggregate as tagg
from raft_tpu_torch.obs import explain as texp
from raft_tpu_torch.obs import flight as tfl
from raft_tpu_torch.obs import report as trep
from raft_tpu_torch.obs import slo as tslo
from raft_tpu_torch.obs import tracing as ttr

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

#: (obs, resilience, aggregate, explain, flight, report, slo, progress)
JAX = (jobs, jres, jagg, jexp, jfl, jrep, jslo, jprog)
PORT = (tobs, tres, tagg, texp, tfl, trep, tslo, tprog)


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.delenv("RAFT_TPU_PROCESS_INDEX", raising=False)
    monkeypatch.delenv("RAFT_TPU_PROCESS_COUNT", raising=False)
    monkeypatch.delenv("RAFT_TPU_FLEET_EPOCH", raising=False)
    monkeypatch.delenv("RAFT_TPU_OBS_ROUND", raising=False)

    def reset():
        for res in (jres, tres):
            res.clear_faults()
            res.clear_events()
            res.reset_shard_health()
        for ob in (jobs, tobs):
            ob.disable()
            ob.reset()
            ob.tracing.clear_spans()
            ob.tracing.reset_fleet_ids()

    reset()
    yield
    reset()


def _strip(rec, keys=("t", "t_epoch", "t_mono", "elapsed_s")):
    """A record without its clock readings (recursively)."""
    if isinstance(rec, dict):
        return {k: _strip(v, keys) for k, v in rec.items() if k not in keys}
    if isinstance(rec, list):
        return [_strip(v, keys) for v in rec]
    return rec


# ---------------------------------------------------------------------------
# tracing.clock_handshake, bench/progress
# ---------------------------------------------------------------------------


def test_clock_handshake_has_the_jax_record_and_reads_the_fleet_epoch(
        monkeypatch):
    for env in ({}, {"RAFT_TPU_FLEET_EPOCH": "1000.5",
                     "RAFT_TPU_PROCESS_INDEX": "3",
                     "RAFT_TPU_PROCESS_COUNT": "4"},
                {"RAFT_TPU_FLEET_EPOCH": "garbage"}):
        for key in ("RAFT_TPU_FLEET_EPOCH", "RAFT_TPU_PROCESS_INDEX",
                    "RAFT_TPU_PROCESS_COUNT"):
            monkeypatch.delenv(key, raising=False)
        for key, val in env.items():
            monkeypatch.setenv(key, val)
        j, t = jtr.clock_handshake(), ttr.clock_handshake()
        assert sorted(j) == sorted(t)
        assert _strip(j, ("t_epoch", "t_mono", "offset_s")) == \
            _strip(t, ("t_epoch", "t_mono", "offset_s"))
        if "1000.5" in env.values():
            assert t["offset_s"] == pytest.approx(t["t_epoch"] - 1000.5,
                                                  abs=1e-5)
            assert (t["process_index"], t["process_count"]) == (3, 4)
        else:
            assert t["offset_s"] == 0.0
    assert ttr.clock_handshake(reference_epoch=5.0)["offset_s"] == \
        pytest.approx(ttr.clock_handshake()["t_epoch"] - 5.0, abs=1.0)


@pytest.mark.parametrize("writer,reader", [(tprog, jprog), (jprog, tprog)],
                         ids=["port_to_jax", "jax_to_port"])
def test_progress_files_cross_and_a_torn_line_is_salvaged(tmp_path, writer,
                                                          reader):
    path = str(tmp_path / "hb.jsonl")
    w = writer.ProgressWriter(path, platform="gpu", pulse_interval_s=60.0)
    w.start({"dataset": "siftlike", "n": 1_000_000, "dim": 128, "k": 10})
    w.section("ivf_flat", {"qps": 1000.0, "recall": 0.97})
    w.section("ivf_pq", {"qps": 2000.0, "recall": 0.96})
    w._stop.set()
    with open(path, "a") as f:
        f.write('{"type": "section", "name": "cagra", "da')   # torn append
    records = reader.read_progress(path)
    assert [r["type"] for r in records] == ["run_start", "section",
                                            "section"]
    assert records == writer.read_progress(path)
    got, want = reader.salvage(records, path), writer.salvage(records, path)
    assert got == want
    assert got["metric"] == "ivf_pq_qps_siftlike1000k_128d_k10_recall0.96"
    assert got["salvaged"] and got["recall_gate_met"]


def test_progress_artifacts_and_metrics_match_the_jax_writer(tmp_path,
                                                             monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PROCESS_INDEX", "2")
    monkeypatch.setenv("RAFT_TPU_PROCESS_COUNT", "3")
    assert tprog.process_info() == jprog.process_info() == (2, 3)
    doc = {"a": [1, 2.5, None], "b": {"c": "d"}}
    for mod, name in ((jprog, "j"), (tprog, "t")):
        mod.write_artifact(str(tmp_path / f"{name}.json"), doc)
        mod.export_metrics(str(tmp_path / f"{name}.jsonl"),
                           {"counters": {"x": 1}}, {"run": "r"})
    assert (tmp_path / "j.json").read_bytes() == \
        (tmp_path / "t.json").read_bytes()
    lines = [_strip(json.loads((tmp_path / f"{n}.jsonl").read_text()))
             for n in "jt"]
    assert lines[0] == lines[1] == {"process_index": 2, "process_count": 3,
                                    "run": "r", "counters": {"x": 1}}
    (tmp_path / "stale.jsonl").write_text("x")
    (tmp_path / "stale.jsonl.tmp").write_text("x")
    tprog.truncate_dir(str(tmp_path), prefix="stale")
    assert not (tmp_path / "stale.jsonl").exists()
    assert not (tmp_path / "stale.jsonl.tmp").exists()
    tprog.truncate(str(tmp_path / "t.jsonl"))
    assert (tmp_path / "t.jsonl").read_text() == ""
    monkeypatch.delenv("RAFT_TPU_BENCH_HEARTBEAT", raising=False)
    assert isinstance(tprog.from_env(), tprog.NullProgress)
    monkeypatch.setenv("RAFT_TPU_BENCH_HEARTBEAT", str(tmp_path / "h.jsonl"))
    assert isinstance(tprog.from_env("gpu"), tprog.ProgressWriter)


def test_progress_and_aggregate_load_without_torch():
    """A parent that never imported torch loads both files by path."""
    code = (
        "import importlib.util, sys\n"
        "for name in ('bench/progress.py', 'obs/aggregate.py'):\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name.replace('/', '_')[:-3], 'raft_tpu_torch/' + name)\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "assert 'torch' not in sys.modules, 'torch imported'\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---------------------------------------------------------------------------
# obs/aggregate: merge and stitch
# ---------------------------------------------------------------------------


def _snapshots(ob, seed):
    """Per-'process' snapshots from a package's real registry."""
    rng = np.random.default_rng(seed)
    snaps = []
    for p in range(3):
        ob.reset()
        ob.enable()
        ob.add("serving.requests.ok", int(rng.integers(1, 50)))
        ob.add("tiles", float(rng.random()))
        for v in rng.exponential(0.01, 20):
            ob.observe("serving.request_latency_s", float(v))
        ob.set_gauge("memory.card.bytes_in_use", int(rng.integers(1, 1e9)))
        ob.set_gauge("memory.card.bytes_in_use", int(rng.integers(1, 1e9)))
        with ob.record_span(f"phase{p}"):
            pass
        snap = ob.snapshot()
        snaps.append({"t": 10.0 + p, "process_index": p, "process_count": 3,
                      "_source": f"p{p}.jsonl", **snap})
    ob.disable()
    ob.reset()
    return snaps


def _trace(pi, shift):
    return {"traceEvents": [
        {"name": "search", "ph": "X", "ts": 1000.0 + shift, "dur": 5.0,
         "pid": pi, "tid": 7,
         "args": {"trace_id": "ab-1", "span_id": "ab-2", "parent_id": None,
                  "fleet_trace_id": "fleet:distributed.tiled_search:1"}},
        {"name": "event", "ph": "i", "ts": 990.0 + shift, "pid": pi,
         "tid": 0, "s": "p", "args": {"kind": "TRANSIENT"}}],
        "displayTimeUnit": "ms",
        "otherData": {"process_index": pi, "process_count": 2}}


@pytest.mark.parametrize("maker", ["jax", "port"])
def test_merges_equal_the_jax_merge(maker):
    snaps = _snapshots(jobs if maker == "jax" else tobs, 5)
    handshakes = [dict(ttr.clock_handshake(), t=5.0, process_index=p)
                  for p in range(2)]
    assert tagg.merge_snapshots(copy.deepcopy(snaps)) == \
        jagg.merge_snapshots(copy.deepcopy(snaps))
    records = snaps + handshakes + [dict(snaps[0], t=1.0)]
    got = tagg.merge_records(copy.deepcopy(records))
    assert got == jagg.merge_records(copy.deepcopy(records))
    assert got["processes"] == [0, 1, 2] and "clock_offsets" in got
    hist = got["histograms"]["serving.request_latency_s"]
    assert hist["count"] == 60 and "p99_ub" in hist


def test_stitch_and_files_equal_the_jax_stitch(tmp_path):
    docs = [_trace(0, 0.0), None, _trace(0, 50.0), _trace(1, 20.0)]
    offsets = {"p0": {"offset_s": 0.25}, "p1": {"offset_s": -0.5}}
    got = tagg.stitch_traces(copy.deepcopy(docs), clock_offsets=offsets)
    assert got == jagg.stitch_traces(copy.deepcopy(docs),
                                     clock_offsets=offsets)
    assert got["otherData"]["processes"] == [0, 1, 2]
    xs = [e for e in got["traceEvents"] if e.get("ph") == "X"]
    assert {e["args"]["fleet_trace_id"] for e in xs} == \
        {"fleet:distributed.tiled_search:1"}
    assert {e["args"]["span_id"] for e in xs} == {"p0/ab-2", "p1/ab-2",
                                                  "p2/ab-2"}
    # the stitcher subtracts each host's offset_s
    # (the second export claiming process 0 is re-homed on track 1)
    assert sorted(e["ts"] for e in xs) == [1000.0 - 0.25e6, 1020.0,
                                           1050.0 + 0.5e6]
    paths = []
    for i, snap in enumerate(_snapshots(tobs, 9)):
        p = tmp_path / f"m{i}.jsonl"
        p.write_text(json.dumps(snap) + "\n" + '{"torn": ')
        paths.append(str(p))
    assert tagg.merge_files(paths) == jagg.merge_files(paths)
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert tagg.read_trace(str(bad)) is None is jagg.read_trace(str(bad))


def test_aggregate_cli_runs_as_a_module(tmp_path):
    traces = []
    for pi in range(2):
        p = tmp_path / f"p{pi}.json"
        p.write_text(json.dumps(_trace(pi, 10.0 * pi)))
        traces.append(str(p))
    hs = tmp_path / "hs.jsonl"
    hs.write_text("".join(json.dumps(dict(ttr.clock_handshake(),
                                          process_index=pi)) + "\n"
                          for pi in range(2)))
    out = tmp_path / "fleet.json"
    proc = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.obs.aggregate", "--stitch",
         *traces, "--handshakes", str(hs), "--output", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "RuntimeWarning" not in proc.stderr
    doc = json.loads(out.read_text())
    assert doc["otherData"]["processes"] == [0, 1]
    proc = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.obs.aggregate",
         str(tmp_path / "missing.jsonl")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2


# ---------------------------------------------------------------------------
# obs/slo: one synthetic clock, one scripted stream
# ---------------------------------------------------------------------------


class _ScriptedRegistry:
    """A registry stand-in whose snapshot is whatever the script set."""

    def __init__(self):
        self.snap = {"counters": {}, "histograms": {}}

    def snapshot(self):
        return copy.deepcopy(self.snap)


class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


class _Counts:
    def __init__(self):
        self.matched, self.total = 0, 0

    def __call__(self):
        return self.matched, self.total


def _engine(slo_mod, reg, clock, counts):
    slos = (slo_mod.latency_slo("p99", "serving.request_latency_s",
                                target_s=0.006, quantile=0.99),
            slo_mod.availability_slo("avail", target=0.99),
            slo_mod.recall_slo("recall", counts, floor=0.9))
    return slo_mod.SloEngine(slos, registry=reg, fast_window_s=10.0,
                             slow_window_s=40.0, threshold=5.0, clock=clock)


def test_slo_engines_reach_equal_burn_states_on_one_stream():
    """Calm, a latency burst whose pow2 bucket (le_0.0078125) straddles the
    6 ms target — counted bad, the ≤2× conservative convention kept — an
    availability burst, a recall dip, recovery; a failing recall source."""
    rng = np.random.default_rng(3)
    regs, clocks, counts = ([_ScriptedRegistry() for _ in range(2)],
                            [_Clock() for _ in range(2)],
                            [_Counts() for _ in range(2)])
    tobs.enable()
    jobs.enable()
    engines = [_engine(m, r, c, n) for m, r, c, n in
               zip((jslo, tslo), regs, clocks, counts)]
    buckets, ok, bad, matched, total = {}, 0, 0, 0, 0
    states = []
    for step in range(56):
        phase = min(step // 8, 4)
        lat = 0.007 if phase == 1 else 0.0005
        for v in rng.exponential(lat, 50):
            key = f"le_{2.0 ** np.ceil(np.log2(max(v, 1e-9))):.10g}"
            buckets[key] = buckets.get(key, 0) + 1
        ok += 50
        bad += 10 if phase == 2 else 0
        total += 100
        matched += 70 if phase == 3 else 97
        for reg, clock, cnt in zip(regs, clocks, counts):
            reg.snap = {"counters": {"serving.requests.ok": ok,
                                     "serving.requests.fatal": bad},
                        "histograms": {"serving.request_latency_s": {
                            "count": sum(buckets.values()),
                            "buckets": dict(buckets)}}}
            clock.now = 2.0 * (step + 1)
            cnt.matched, cnt.total = matched, total
        rows = [e.evaluate() for e in engines]
        assert rows[0] == rows[1], step
        states.append({n: r["state"] for n, r in rows[1].items()})
    seen = {s for row in states for s in row.values()}
    assert {"ok", "warn", "breach"} <= seen
    assert states[-1] == {"p99": "ok", "avail": "ok", "recall": "ok"}
    # a latency bucket straddling the target counts bad (≤2× overcount)
    assert any(s["p99"] == "breach" for s in states[8:16])
    breaches = [[e for e in r.recent_events() if e["event"] == "slo_breach"]
                for r in (jres, tres)]
    assert _strip(breaches[0]) == _strip(breaches[1]) and breaches[1]
    assert tobs.snapshot()["counters"] == {
        k: v for k, v in jobs.snapshot()["counters"].items()
        if k.startswith("slo.")}

    def broken():
        raise RuntimeError("shadow source down")

    for slo_mod, ob in ((jslo, jobs), (tslo, tobs)):
        eng = slo_mod.SloEngine(
            (slo_mod.recall_slo("recall", broken, floor=0.9),),
            registry=_ScriptedRegistry(), clock=lambda: 1.0)
        assert eng.evaluate()["recall"]["state"] == "unknown"
    assert tobs.snapshot()["counters"]["slo.source_error.fatal"] == \
        jobs.snapshot()["counters"]["slo.source_error.fatal"]


def test_slo_constructors_validate_as_the_jax_ones():
    for mod in (jslo, tslo):
        with pytest.raises(ValueError):
            mod.latency_slo("x", "h", 0.01, quantile=1.0)
        with pytest.raises(ValueError):
            mod.availability_slo("x", target=1.0)
        with pytest.raises(ValueError):
            mod.Slo("x", "bogus", 1.0, 0.1)
        with pytest.raises(ValueError):
            mod.SloEngine([mod.availability_slo("a"),
                           mod.availability_slo("a")])
    sampler = type("S", (), {"counts": lambda self: (1, 1)})()
    j = jslo.default_serving_slos(0.01, sampler=sampler)
    t = tslo.default_serving_slos(0.01, sampler=sampler)
    assert [(s.name, s.kind, s.target, s.budget) for s in j] == \
        [(s.name, s.kind, s.target, s.budget) for s in t]


# ---------------------------------------------------------------------------
# obs/report and obs/explain: records fed both ways
# ---------------------------------------------------------------------------


class _Queue:
    depth, batch_cap, batches, multi_batches = 40, 8, 12, 9


class _Sampler:
    def estimate(self):
        return {"recall": 0.82, "ci_low": 0.78, "ci_high": 0.86,
                "samples": 300}

    def counts(self):
        return 820, 1000


def _collect(pkg, clock_now=5.0):
    """One report from a package's real ``collect``: an SLO engine over the
    package's own registry, the fake queue and sampler."""
    ob, res, _, _, _, rep, slo_mod, _ = pkg
    ob.reset()
    ob.enable()
    ob.add("serving.requests.ok", 90)
    ob.add("serving.requests.deadline", 10)
    ob.add("serving.queue.requeued", 2)
    for v in (0.001, 0.003, 0.02, 0.04):
        ob.observe("serving.request_latency_s", v)
    ob.set_gauge("memory.card.bytes_in_use", 123456)
    sampler = _Sampler()
    clock = _Clock()
    engine = slo_mod.SloEngine(
        slo_mod.default_serving_slos(0.005, sampler=sampler,
                                     recall_floor=0.9),
        fast_window_s=10.0, slow_window_s=40.0, clock=clock)
    clock.now = clock_now
    out = rep.collect(engine=engine, sampler=sampler, queue=_Queue(),
                      window=3)
    ob.disable()
    return out


def _synthetic_reports():
    """Reports covering every diagnosis kind and the validator's checks."""
    base = {"t": 1.0, "type": "obs_report", "schema_version": 6,
            "window": 1, "errors": {},
            "slo": {"serving_p99": {"kind": "latency", "state": "ok",
                                    "burn_fast": 0.0, "burn_slow": 0.0}},
            "memory": {"memory.x": {"value": 10, "max": 10}},
            "verdicts": {"ok": 5, "unclassified": 0}}
    roof = {"peaks": {"source": "table"}, "entries": {
        "ivf_flat.paged_pallas": {"bound": "compute", "mxu_utilization": 0.1,
                                  "hbm_bw_utilization": 0.05,
                                  "measured_s": 0.002, "dispatches": 4,
                                  "flops": 1e9, "bytes": 1e6,
                                  "padded_fraction": 0.4,
                                  "occupancy": {"tile_fill": 0.3}},
        "ivf_pq.search": {"bound": "memory", "hbm_bw_utilization": 0.7,
                          "measured_s": 0.001, "flops": 1e8,
                          "bytes": 1e8}}}
    out = [dict(base, roofline=roof,
                compile={"total_traces": 7, "unexplained_retraces": 0}),
           dict(base, compile={"total_traces": 9,
                               "unexplained_retraces": 1}),
           dict(base, admission={"admit": 3, "queue": 2, "reject": 1},
                queue={"depth": 40, "batch_cap": 8, "requeued": 1}),
           dict(base, errors={"roofline": "FATAL"}),
           dict(base, slo={"serving_p99": {"kind": "latency",
                                           "state": "breach",
                                           "burn_fast": 30.0,
                                           "burn_slow": 9.0}}),
           dict(base, roofline={"peaks": {"source": "unknown"},
                                "entries": {"x": {"bound": "memory",
                                                  "flops": -1,
                                                  "bytes": 0}}},
                tuning={"actions": 3, "nudges": 1, "reverts": 1,
                        "holds": 0, "failures": 0, "knobs": {}},
                capacity={"resident_bytes": 10, "budget_bytes": 5,
                          "tenants": {"a": {"tier": "lukewarm",
                                            "resident_bytes": 1}}},
                maintenance={"drift_score": float("nan"), "cycles": 1,
                             "stale_aborts": 0, "failures": -1}),
           dict(base, schema_version=2),
           {"type": "not_a_report"}]
    return out


def test_explain_and_report_validate_equal_on_both_packages_records():
    made = [_collect(JAX), _collect(PORT)]
    for rec in made:
        assert sorted(rec) == sorted(made[0])
        assert rec["schema_version"] == jrep.SCHEMA_VERSION == \
            trep.SCHEMA_VERSION
    records = made + _synthetic_reports()
    seen = set()
    for i, rec in enumerate(records):
        assert trep.validate(copy.deepcopy(rec)) == \
            jrep.validate(copy.deepcopy(rec)), i
        if rec.get("type") != "obs_report":
            for mod in (jexp, texp):
                with pytest.raises(ValueError):
                    mod.explain(rec)
            continue
        prev = records[i - 1] if i and records[i - 1].get("type") == \
            "obs_report" else None
        t = texp.explain(copy.deepcopy(rec), prev=copy.deepcopy(prev))
        assert t == jexp.explain(copy.deepcopy(rec), prev=copy.deepcopy(prev))
        assert texp.validate(t) == jexp.validate(t) == []
        seen |= {d["kind"] for d in t["diagnoses"]}
    assert texp.KINDS == jexp.KINDS
    assert seen == set(texp.KINDS)
    bad = {"type": "explain", "schema_version": 1, "primary": "x",
           "healthy": True,
           "diagnoses": [{"kind": "unknown", "score": 0.2, "evidence": {}},
                         {"kind": "nope", "score": 0.9}]}
    assert texp.validate(bad) == jexp.validate(bad) and len(
        texp.validate(bad)) == 5
    # the port's record names the port's sections, in JAX's schema
    port = made[1]
    assert port["compile"]["unexplained_retraces"] == 0
    assert port["roofline"]["peaks"]["source"] == "unknown"
    assert port["verdicts"] == {"ok": 90, "deadline": 10, "unclassified": 0}
    assert trep.validate(port) == []


def test_report_export_render_and_cli(tmp_path):
    rec = _collect(PORT)
    path = str(tmp_path / "rep.jsonl")
    trep.export(path, rec)
    jrec = _collect(JAX)
    jrep.export(path, dict(jrec, t=rec["t"] - 1.0))
    with open(path, "a") as f:
        f.write('{"type": "obs_report", "t": 9e9, "to')
    assert json.loads(trep.render(rec)) == json.loads(jrep.render(rec))
    proc = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.obs.report", path,
         "--validate"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "report: valid" in proc.stderr
    newest = json.loads(proc.stdout)
    assert newest["window"] == 3 and newest["t"] == rec["t"]
    assert jrep.validate(newest) == []
    proc = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.obs.report",
         str(tmp_path / "none.jsonl")], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 2


# ---------------------------------------------------------------------------
# obs/flight: recordings made by either package, read by both
# ---------------------------------------------------------------------------


def _recording(pkg, path, windows=5):
    """A real recording: the package's FlightRecorder over its own registry,
    two knob vectors, an event and a classified degraded window."""
    ob, res = pkg[0], pkg[1]
    flight = pkg[4]
    ob.reset()
    ob.enable()
    knobs = {"algo": "ivf_flat", "n_probes": 8}
    rec = flight.FlightRecorder(path, knobs=lambda: dict(knobs),
                                health={"healthy": True, "platform": "cpu"},
                                interval_s=60.0)
    for w in range(windows):
        ob.add("serving.requests.ok", 40 + 10 * w)
        for v in (0.001, 0.002, 0.004 * (w + 1)):
            ob.observe("serving.request_latency_s", v)
        if w == 2:
            knobs["n_probes"] = 16
            res.record_event("tuning.action", knob="n_probes", frm=8, to=16,
                             action="revert", reason="recall")
        if w == 3:
            res.arm_faults("obs.flight.sample=transient:1")
        rec.sample(now=float(w))
    ob.disable()
    res.clear_faults()
    return flight.read_recording(path)


def _normalised(records):
    """A recording without its clocks, process-local ids and resilience
    event payloads' timestamps (what two runs cannot share)."""
    return _strip(records, ("t", "t_epoch", "t_mono", "trace_id", "span_id",
                            "tid"))


@pytest.mark.parametrize("maker", ["jax", "port"])
def test_flight_analysis_equal_on_both_packages_recordings(tmp_path, maker):
    path = str(tmp_path / "rec.jsonl")
    records = _recording(JAX if maker == "jax" else PORT, path)
    with open(path, "a") as f:
        f.write('{"type": "flight_window", "window": 99, "sch')  # torn
    assert tfl.read_recording(path) == jfl.read_recording(path) == records
    assert tfl.validate(records) == jfl.validate(records) == []
    assert tfl.extract_frontier(records) == jfl.extract_frontier(records)
    assert tfl.render(records) == jfl.render(records)
    wins = [r for r in records if r["type"] == "flight_window"]
    assert wins[3]["errors"] == {"sample": "transient"}
    assert wins[0]["health"]["healthy"] is True
    assert any(e["event"] == "tuning.action"
               for e in wins[2]["events"])
    front = tfl.extract_frontier(records)
    assert front["points"] == 2 and front["pareto_points"] >= 1
    broken = [dict(r) for r in records]
    broken[1] = dict(broken[1], errors={"x": "WEIRD"}, window=-1)
    del broken[0]
    assert tfl.validate(broken) == jfl.validate(broken) != []
    assert tfl.validate([]) == jfl.validate([])


def test_both_recorders_write_the_same_windows(tmp_path):
    """The same script through both recorders gives the same recording,
    clocks aside."""
    recs = [_normalised(_recording(pkg, str(tmp_path / f"{i}.jsonl")))
            for i, pkg in enumerate((JAX, PORT))]
    for a, b in zip(*recs):
        if a.get("type") == "flight_window":
            a, b = dict(a), dict(b)
            ra, rb = a.pop("report", None), b.pop("report", None)
            # the embedded reports' planes are each package's own: compare
            # the sections both measure alike
            if ra is not None:
                for key in ("slo", "recall", "queue", "memory", "verdicts",
                            "schema_version", "window", "type", "capacity",
                            "maintenance", "tuning", "shard_health"):
                    assert ra.get(key) == rb.get(key), key
            for e in a.get("events") or []:
                e.pop("site", None)
            for e in b.get("events") or []:
                e.pop("site", None)
        assert a == b


def test_fingerprint_equals_the_jax_hash(monkeypatch):
    rng = np.random.default_rng(4)
    for i in range(20):
        knobs = {"algo": ["ivf_flat", "ivf_pq", "cagra"][i % 3],
                 "n_probes": int(rng.integers(1, 512)),
                 "slo_s": float(rng.random()), "k": 10,
                 "batch_cap": int(rng.integers(1, 64)),
                 "tiers": {"hot": int(rng.integers(0, 4)), "warm": 1}}
        if i % 4 == 0:
            knobs["process_count"] = 8
        monkeypatch.setenv("RAFT_TPU_PROCESS_COUNT", str(1 + i % 3))
        monkeypatch.setenv("RAFT_TPU_PROCESS_INDEX", "0")
        assert tfl.fingerprint(knobs) == jfl.fingerprint(knobs)
    assert tfl.fingerprint({})["fp"] == jfl.fingerprint({})["fp"]


def test_disabled_recorder_holds_zero_state(tmp_path):
    path = str(tmp_path / "off.jsonl")
    rec = tfl.FlightRecorder(path, knobs={"algo": "x"})
    assert not rec.enabled
    assert rec.maybe_sample() is None and rec.sample() is None
    assert rec.records() == [] and rec.windows_recorded == 0
    rec.start()
    rec.stop()
    assert not hasattr(rec, "_ring") and not hasattr(rec, "_knobs")
    assert not os.path.exists(path)


def test_window_zero_carries_the_health_probe_verdict(tmp_path):
    """With no verdict given, the recorder runs the port's health probe
    (a bounded child) on the first window only."""
    from raft_tpu_torch.obs import health

    calls = []
    orig = health.probe

    def probe(platform="default", timeout=20.0, child_code=None):
        calls.append((platform, timeout))
        return orig("cpu", timeout=timeout)

    tobs.enable()
    health.probe = probe
    try:
        rec = tfl.FlightRecorder(str(tmp_path / "h.jsonl"), knobs={},
                                 probe_health=True, interval_s=60.0)
        first = rec.sample(now=0.0)
        second = rec.sample(now=1.0)
    finally:
        health.probe = orig
    assert calls == [("default", 10.0)]
    assert first["health"]["healthy"] is True
    assert first["health"]["backend"] == "cpu"
    assert "health" not in second
    assert tfl.validate(tfl.read_recording(str(tmp_path / "h.jsonl"))) == []


def test_flight_cli_validates_renders_and_extracts_the_frontier(tmp_path):
    path = str(tmp_path / "rec.jsonl")
    _recording(PORT, path)
    front = tmp_path / "f.json"
    proc = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.obs.flight", path,
         "--validate", "--render", "--frontier", str(front)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "flight: valid" in proc.stderr
    assert "w  0" in proc.stdout and "health=ok" in proc.stdout
    assert json.loads(front.read_text()) == \
        jfl.extract_frontier(jfl.read_recording(path))


# ---------------------------------------------------------------------------
# the obs package's exports
# ---------------------------------------------------------------------------


def test_obs_exports_equal_the_jax_package():
    assert sorted(tobs.__all__) == sorted(jobs.__all__)
    tree = ast.parse((REPO / "raft_tpu_torch/obs/__init__.py").read_text())
    imported = {a.name for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) for a in n.names}
    assert not imported & {"aggregate", "report", "flight", "slo",
                           "explain"}


def test_handshake_stamps_and_recording_initialise_no_cuda_context(tmp_path):
    """The handshake, both ``process_info`` twins, a fingerprint and a
    recorded window (with a given health verdict) never initialise CUDA:
    the child makes CUDA's lazy init raise."""
    code = (
        "import torch\n"
        "def boom(*a, **k):\n"
        "    raise AssertionError('CUDA initialised')\n"
        "torch.cuda._lazy_init = boom\n"
        "from raft_tpu_torch import obs\n"
        "from raft_tpu_torch.bench import progress\n"
        "from raft_tpu_torch.obs import flight, tracing\n"
        "assert tracing.clock_handshake()['type'] == 'clock_offset'\n"
        "assert progress.process_info() == tracing.process_info() == (0, 1)\n"
        "assert flight.fingerprint({'k': 10})['fp']\n"
        "obs.enable()\n"
        f"rec = flight.FlightRecorder({str(tmp_path / 'r.jsonl')!r},\n"
        "                             knobs={'k': 10},\n"
        "                             health={'healthy': True})\n"
        "assert rec.sample()['health'] == {'healthy': True}\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAFT_TPU_PROCESS_")}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
