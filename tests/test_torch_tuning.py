"""The tuning loop of the port — ``tuning/autotune`` (the offline tuner,
the operating point) and ``serving/controller`` (the burn-rate controller)
— held against the JAX package.

* One scripted ``serve_fn`` drives both packages' ``Autotuner``: the same
  diagnoses, proposals and knob moves window by window, the same frontier
  and the same operating point (timestamps and the ``tuned_by`` stamp
  aside), each package reading the other's file.
* One scripted SLO stream drives both ``BurnRateController``s: the same
  tick decisions, reports and ``tuning.action`` events.
* Faultpoints (``tuning.autotune.window``, ``serving.controller.tick``)
  surface classified in both, and telemetry off holds zero state.
* End to end at the JAX rung's tiny shape (1500 × 16, n_lists 16): each
  package's tuner over its own paged flat store on the CPU meets the SLO.
"""

import copy
import json
import threading
import time

import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu import resilience as jres
from raft_tpu import serving as jsv
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.obs import explain as jexp
from raft_tpu.obs import report as jrep
from raft_tpu.obs import shadow as jshadow
from raft_tpu.obs import slo as jslo
from raft_tpu.tuning import autotune as jat
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import resilience as tres
from raft_tpu_torch import serving as tsv
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.obs import explain as texp
from raft_tpu_torch.obs import report as trep
from raft_tpu_torch.obs import shadow as tshadow
from raft_tpu_torch.obs import slo as tslo
from raft_tpu_torch.tuning import autotune as tat

torch.set_num_threads(2)

#: (obs, resilience, autotune, serving, explain, report) of each package
JAX = (jobs, jres, jat, jsv, jexp, jrep)
PORT = (tobs, tres, tat, tsv, texp, trep)


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    for env in ("RAFT_TPU_TUNE_MAX_WINDOWS", "RAFT_TPU_TUNE_DEADLINE_S",
                "RAFT_TPU_TUNE_OPERATING_POINT", "RAFT_TPU_TUNE_MAX_ACTIONS",
                "RAFT_TPU_TUNE_COOL_WINDOWS", "RAFT_TPU_TUNE_INTERVAL_S"):
        monkeypatch.delenv(env, raising=False)

    def reset():
        for res in (jres, tres):
            res.clear_faults()
            res.clear_events()
        for ob in (jobs, tobs):
            ob.disable()
            ob.reset()
            ob.tracing.clear_spans()

    reset()
    yield
    reset()


def _enable():
    for ob in (jobs, tobs):
        ob.reset()
        ob.enable()


def _strip(rec, keys=("t",)):
    if isinstance(rec, dict):
        return {k: _strip(v, keys) for k, v in rec.items() if k not in keys}
    if isinstance(rec, list):
        return [_strip(v, keys) for v in rec]
    return rec


def _events(res, name):
    return [_strip({k: v for k, v in e.items() if k != "error"})
            for e in res.recent_events() if e.get("event") == name]


# ---------------------------------------------------------------------------
# the offline tuner on one scripted serve_fn
# ---------------------------------------------------------------------------

#: recall / qps / p99 of a synthetic serving surface over (n_probes, cap)
_FLOOR = 0.9


def _serve(values):
    n_probes, cap = values["n_probes"], values.get("batch_cap", 8)
    recall = {2: 0.6, 4: 0.8, 8: 0.93, 16: 0.97}[n_probes]
    qps = 3000.0 / n_probes * (1.0 + cap / 16.0)
    state = "breach" if recall < _FLOOR else "ok"
    roof = {"peaks": {"source": "table"}, "entries": {
        "ivf_flat.paged_pallas": {"bound": "compute",
                                  "mxu_utilization": 0.2 if cap < 16
                                  else 0.8,
                                  "measured_s": 0.001, "flops": 1e9,
                                  "bytes": 1e6}}}
    report = {"t": 1.0, "type": "obs_report", "schema_version": 6,
              "errors": {}, "window": 0,
              "recall": {"recall": recall, "ci_low": recall - 0.02,
                         "ci_high": recall + 0.02, "samples": 400},
              "slo": {"serving_recall": {"kind": "recall", "state": state,
                                         "target": _FLOOR, "value": recall,
                                         "burn_fast": 20.0
                                         if state == "breach" else 0.0}},
              "roofline": roof,
              "compile": {"total_traces": 4, "unexplained_retraces": 0}}
    return {"ops": {"qps": qps, "p99_ub_s": 0.001 * cap},
            "report": report}


def _tuner(at, **kw):
    kw.setdefault("slo", {"p99_s": 0.02, "recall_floor": _FLOOR})
    kw.setdefault("settle", 2)
    kw.setdefault("deadline_s", 5.0)
    return at.Autotuner(_serve, [at.Knob("n_probes", [2, 4, 8, 16]),
                                 at.Knob("batch_cap", [4, 8, 16], start=8),
                                 at.Knob("algo", ["ivf_flat"])], **kw)


def test_tuners_propose_the_same_moves_and_operating_point(tmp_path):
    _enable()
    tuners = [_tuner(pkg[2]) for pkg in (JAX, PORT)]
    stats = [t.run(max_windows=12) for t in tuners]
    assert stats[0] == stats[1]
    assert stats[1]["moves"] >= 3 and stats[1]["converged"]
    wins = [t.windows() for t in tuners]
    assert _strip(wins[0]) == _strip(wins[1])
    moves = [w["proposal"]["move"] for w in wins[1]]
    assert moves[0] == {"knob": "n_probes", "frm": 2, "to": 4}
    assert {"knob": "batch_cap", "frm": 8, "to": 16} in moves
    assert [w["explain"]["primary"] for w in wins[1]][:2] == \
        ["recall_limited", "recall_limited"]
    assert _strip(tuners[0].frontier()) == _strip(tuners[1].frontier())
    docs = [t.emit_operating_point(path=str(tmp_path / f"op{i}.json"))
            for i, t in enumerate(tuners)]
    assert _strip(docs[0], ("t", "tuned_by")) == \
        _strip(docs[1], ("t", "tuned_by"))
    assert docs[1]["tuned_by"] == "raft_tpu_torch.tuning.autotune"
    assert docs[1]["meets_slo"] and docs[1]["knobs"]["n_probes"] == 8
    assert sorted(docs[1]) == sorted(docs[0])
    # each package reads the other's operating point
    assert tat.load_operating_point(str(tmp_path / "op0.json")) == \
        json.loads(json.dumps(docs[0]))
    assert jat.load_operating_point(str(tmp_path / "op1.json")) == \
        json.loads(json.dumps(docs[1]))
    assert _events(jres, "tuning.propose") == _events(tres, "tuning.propose")


def test_tuners_stream_windows_and_hold_at_a_ladder_bound(tmp_path):
    _enable()
    paths = [str(tmp_path / f"w{i}.jsonl") for i in range(2)]
    for pkg, path in zip((JAX, PORT), paths):
        at = pkg[2]
        tuner = at.Autotuner(lambda v: _serve({"n_probes": 2}),
                             [at.Knob("n_probes", [2])],
                             slo={"recall_floor": _FLOOR}, settle=2,
                             path=path)
        st = tuner.run(max_windows=3)
        assert st["moves"] == 0 and st["holds"] == 3 and not st["converged"]
        assert tuner.windows()[-1]["proposal"]["reason"] == \
            "no_applicable_knob"
    lines = [[json.loads(x) for x in open(p)] for p in paths]
    assert _strip(lines[0], ("t", "process_index", "process_count")) == \
        _strip(lines[1], ("t", "process_index", "process_count"))
    assert len(lines[1]) == 3


@pytest.mark.parametrize("fault", ["oom", "fatal", "hang"])
def test_window_faultpoint_skips_one_window_classified(fault):
    _enable()
    out = []
    for pkg in (JAX, PORT):
        res, at = pkg[1], pkg[2]
        tuner = _tuner(at, deadline_s=0.3)
        res.arm_faults(f"tuning.autotune.window={fault}:1")
        t0 = time.perf_counter()
        first = tuner.step()
        assert time.perf_counter() - t0 < 10.0
        second = tuner.step()
        out.append((first, second.get("status"), tuner.stats()["skipped"],
                    [e["kind"] for e in res.recent_events()
                     if e.get("event") == "tuning.window_skipped"]))
    assert out[0] == out[1]
    want = {"oom": tres.OOM, "fatal": tres.FATAL, "hang": tres.DEADLINE}
    assert out[1] == ({"status": want[fault], "window": 0}, None, 1,
                      [want[fault]])
    counters = tobs.snapshot()["counters"]
    assert counters[f"tuning.window.{want[fault].lower()}"] == 1


def test_tuner_and_controller_hold_zero_state_with_telemetry_off():
    assert not tobs.enabled()
    tuner = _tuner(tat)
    assert tuner.enabled is False
    assert tuner.step() is None and tuner.run() == {}
    assert tuner.knob_values() == {} and tuner.windows() == []
    assert tuner.emit_operating_point() is None
    assert tuner.frontier()["points"] == 0
    ctrl, _ = _controller(PORT, _Engine(_hot()))
    assert ctrl.enabled is False
    assert ctrl.pump() is None and ctrl.report() is None
    assert not hasattr(ctrl, "actuators")


def test_operating_point_loader_never_raises(tmp_path, monkeypatch):
    for at in (jat, tat):
        assert at.load_operating_point(str(tmp_path / "absent.json")) is None
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    wrong = tmp_path / "wrong.json"
    wrong.write_text(json.dumps({"type": "flight_window", "knobs": {}}))
    nodir = tmp_path / "dir.json"
    nodir.mkdir()
    for p in (bad, wrong, nodir):
        assert tat.load_operating_point(str(p)) is None
        assert jat.load_operating_point(str(p)) is None
    target = tmp_path / "env.json"
    target.write_text(json.dumps({"type": "operating_point",
                                  "knobs": {"n_probes": 4}}))
    monkeypatch.setenv(tat.OPERATING_POINT_ENV, str(target))
    assert tat.load_operating_point()["knobs"] == {"n_probes": 4}
    assert tat.default_operating_point_path() == \
        jat.default_operating_point_path()
    monkeypatch.setenv(tat.MAX_WINDOWS_ENV, "junk")
    monkeypatch.setenv(tat.DEADLINE_ENV, "-3")
    assert (tat.default_tune_windows(), tat.default_tune_deadline()) == \
        (jat.default_tune_windows(), jat.default_tune_deadline()) == \
        (16, 30.0)
    assert tat.RULE_TABLE == jat.RULE_TABLE


# ---------------------------------------------------------------------------
# the burn-rate controller on one scripted SLO stream
# ---------------------------------------------------------------------------


class _Engine:
    """Scripted SloEngine: ``evaluate()`` returns the next row set (the
    last one sticks)."""

    slos = ()

    def __init__(self, *rows):
        self._rows = list(rows)

    def evaluate(self):
        return copy.deepcopy(self._rows.pop(0) if len(self._rows) > 1
                             else self._rows[0])


def _hot(state="breach"):
    return {"serving_p99": {"kind": "latency", "state": state,
                            "burn_fast": 30.0}}


def _cool():
    return {"serving_p99": {"kind": "latency", "state": "ok",
                            "burn_fast": 0.0}}


def _recall_burn():
    return {"serving_recall": {"kind": "recall", "state": "breach",
                               "burn_fast": 30.0}}


class _Sampler:
    def __init__(self, lows):
        self._lows = list(lows)

    def estimate(self):
        low = self._lows.pop(0) if len(self._lows) > 1 else self._lows[0]
        return {"recall": 0.95, "ci_low": low, "ci_high": 0.99}


def _controller(pkg, engine, sampler=None, floor=None, **kw):
    live = {"n_probes": 8, "cap": 16}
    sv = pkg[3]
    acts = [sv.KnobActuator("n_probes", [2, 4, 8],
                            lambda: live["n_probes"],
                            lambda v: live.__setitem__("n_probes", v),
                            costs_recall=True),
            sv.KnobActuator("cap", [4, 8, 16], lambda: live["cap"],
                            lambda v: live.__setitem__("cap", v))]
    kw.setdefault("max_actions", 1)
    kw.setdefault("cool_windows", 2)
    kw.setdefault("deadline_s", 5.0)
    return sv.BurnRateController(engine, acts, sampler=sampler,
                                 recall_floor=floor, **kw), live


_SCRIPT = ([_hot()] * 3 + [_hot("warn")] + [_cool()] * 5 + [_recall_burn()]
           + [_hot()] * 2 + [_cool()] * 8)


@pytest.mark.parametrize("case", ["plain", "guardrail", "two_actions"])
def test_controllers_take_the_same_actions_on_one_stream(case):
    _enable()
    runs = []
    for pkg in (JAX, PORT):
        kw = {}
        if case == "guardrail":
            kw = dict(sampler=_Sampler([0.95, 0.85, 0.85, 0.95]),
                      floor=0.9)
        if case == "two_actions":
            kw = dict(max_actions=2, cool_windows=1)
        ctrl, live = _controller(pkg, _Engine(*_SCRIPT), **kw)
        ticks = []
        for _ in range(len(_SCRIPT)):
            ticks.append(ctrl.pump())
            ticks[-1]["live"] = dict(live)
        runs.append((ticks, ctrl.report(),
                     _events(pkg[1], "tuning.action"),
                     _events(pkg[1], "tuning.guardrail_hold")))
    assert runs[0] == runs[1]
    ticks, rep, actions, holds = runs[1]
    assert rep["actions"] == rep["nudges"] + rep["reverts"] >= 3
    assert len(actions) == rep["actions"]
    assert ticks[-1]["live"] == {"n_probes": 8, "cap": 16}   # restored
    if case == "guardrail":
        assert rep["guardrail_holds"] >= 1 and holds
    for pkg in (JAX, PORT):
        assert pkg[5].validate({"schema_version": 6, "tuning": rep},
                               require_classes=()) == [
            "no nonzero memory watermark recorded",
            "schema v6 record missing its compile section",
            "schema v6 record missing its roofline section"]


@pytest.mark.parametrize("fault", ["oom", "fatal", "hang"])
def test_tick_faultpoint_is_skipped_classified(fault):
    _enable()
    out = []
    for pkg in (JAX, PORT):
        ctrl, live = _controller(pkg, _Engine(_hot()), deadline_s=0.3)
        pkg[1].arm_faults(f"serving.controller.tick={fault}:1")
        t0 = time.perf_counter()
        first = ctrl.pump()
        assert time.perf_counter() - t0 < 10.0
        second = ctrl.pump()
        out.append((first, second["status"], dict(live),
                    ctrl.report()["failures"],
                    [e["kind"] for e in pkg[1].recent_events()
                     if e.get("event") == "tuning.tick_error"]))
    assert out[0] == out[1]
    want = {"oom": tres.OOM, "fatal": tres.FATAL, "hang": tres.DEADLINE}
    assert out[1][0] == {"status": want[fault], "actions": []}
    assert out[1][1:] == ("hot", {"n_probes": 4, "cap": 16}, 1,
                          [want[fault]])


def test_controller_defaults_and_exports_equal_the_jax_ones(monkeypatch):
    from raft_tpu.serving import controller as jc
    from raft_tpu_torch.serving import controller as tc

    for env, val in ((tc.MAX_ACTIONS_ENV, "3"), (tc.COOL_WINDOWS_ENV, "x"),
                     (tc.CONTROL_INTERVAL_ENV, "0.25")):
        monkeypatch.setenv(env, val)
    assert (tc.default_max_actions(), tc.default_cool_windows(),
            tc.default_control_interval()) == \
        (jc.default_max_actions(), jc.default_cool_windows(),
         jc.default_control_interval()) == (3, 2, 0.25)
    assert sorted(tc.__all__) == sorted(jc.__all__)
    with pytest.raises(ValueError, match="empty ladder"):
        tsv.KnobActuator("x", [], lambda: 1, lambda v: None)
    with pytest.raises(ValueError, match="not on its ladder"):
        tsv.KnobActuator("x", [1, 2], lambda: 3, lambda v: None)
    tobs.enable()
    with pytest.raises(ValueError, match="at least one"):
        tsv.BurnRateController(_Engine(_cool()), [])


def test_tick_thread_moves_the_live_queue_cap_while_it_serves():
    """The controller's own thread nudges a live ``QueryQueue``'s batch cap
    (``set_batch_cap``) while this thread submits and pumps: every request
    is answered with the ids of a direct search, and the cap ends where
    the controller left it."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((1500, 16)).astype(np.float32)
    idx = tfl.build(X, tfl.IvfFlatParams(n_lists=16), device="cpu")
    store = tsv.PagedListStore.from_index(idx, page_rows=64, device="cpu")
    run = tsv.searcher(store, 5, n_probes=4, backend="gather",
                       device="cpu")
    queue = tsv.QueryQueue(run, max_batch=16, fill_wait_s=0.0)
    tobs.enable()
    acts = [tsv.KnobActuator("batch_cap", [4, 8, 16],
                             lambda: queue.batch_cap, queue.set_batch_cap)]
    ctrl = tsv.BurnRateController(_Engine(*([_hot()] * 3 + [_cool()])), acts,
                                  cool_windows=1000, interval_s=0.01,
                                  deadline_s=5.0)
    q = rng.standard_normal((200, 16)).astype(np.float32)
    ctrl.start()
    handles = []
    try:
        for i in range(200):
            handles.append(queue.submit(q[i], timeout_s=30.0))
            if i % 7 == 0:
                queue.pump()
        queue.drain(timeout=60.0)
        deadline = time.monotonic() + 10.0
        while ctrl.report()["nudges"] < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        ctrl.stop()
    assert queue.batch_cap == 4 and ctrl.report()["nudges"] == 2
    assert [h.verdict for h in handles] == ["ok"] * 200
    _, want = run(q)
    got = np.stack([np.asarray(h.result()[1]).reshape(-1)
                    for h in handles])
    np.testing.assert_array_equal(got, want.cpu().numpy())
    assert not any(t.name == "raft-tpu-controller" and t.is_alive()
                   for t in threading.enumerate())


# ---------------------------------------------------------------------------
# end to end at the JAX rung's tiny shape
# ---------------------------------------------------------------------------


def _tiny_tuner_run(pkg, data, q_pool):
    """The JAX rung's phase A at its tiny shape over ``pkg``'s own store:
    probe ladder (2, 4, 8), cap ladder (4, 8, 16), 40 Poisson requests a
    window, every (probe rung ∪ exact) × bucket met before any clock, the
    recall floor in the widest gap of the measured ladder."""
    ob, _, at, sv, ex, rep = pkg
    is_port = pkg is PORT
    shadow, slo_mod = (tshadow, tslo) if is_port else (jshadow, jslo)
    n_lists, k, n_req = 16, 10, 40
    probes, caps = [2, 4, 8], [4, 8, 16]
    dev = {"device": "cpu"} if is_port else {}
    # the port searches with the gather scan, JAX's CPU engine
    scan = {"backend": "gather", **dev} if is_port else {}
    index = (tfl if is_port else jfl).build(
        data, (tfl if is_port else jfl).IvfFlatParams(
            n_lists=n_lists, kmeans_trainset_fraction=0.5), **dev)
    store = sv.PagedListStore.from_index(index, **dev)

    def search(qq, nprobe):
        return sv.search(store, qq, k, n_probes=nprobe, **scan)

    def ids(out):
        return np.asarray(out[1].cpu() if is_port else out[1])

    for np_ in probes + [n_lists]:
        for b in (1, 2, 4, 8, 16):
            ids(search(np.repeat(q_pool[:1], b, axis=0), np_))
    t = time.perf_counter()
    for _ in range(3):
        ids(search(q_pool[:1], probes[-1]))
    lat1 = max(1e-6, (time.perf_counter() - t) / 3)
    t = time.perf_counter()
    ids(search(q_pool[:16], probes[-1]))
    lat_full = max(1e-6, time.perf_counter() - t)
    slo_s = max(4.0 * lat_full, 2.0 * lat1)
    exact = ids(search(q_pool[:16], n_lists))
    ladder = []
    for p in probes:
        got = ids(search(q_pool[:16], p))
        ladder.append(sum(len(set(got[i]) & set(exact[i]))
                          for i in range(16)) / (16 * k))
    gaps = [b - a for a, b in zip(ladder, ladder[1:])]
    if max(gaps) > 0.08:
        gi = gaps.index(max(gaps))
        floor = (ladder[gi] + ladder[gi + 1]) / 2.0
    else:
        floor = ladder[-1] - 0.03
    floor = round(min(0.95, max(0.2, floor)), 3)
    rng = np.random.default_rng(17)

    def serve_window(values):
        sampler = shadow.ShadowSampler(lambda qq: search(qq, n_lists), k=k,
                                       rate=1.0, seed=17,
                                       max_pending=n_req + 8)
        engine = slo_mod.SloEngine(
            slo_mod.default_serving_slos(slo_s, sampler=sampler,
                                         recall_floor=floor),
            fast_window_s=30.0, slow_window_s=120.0)
        queue = sv.QueryQueue(
            sv.searcher(store, k, n_probes=int(values["n_probes"]), **scan),
            slo_s=slo_s, max_batch=int(values["batch_cap"]),
            fill_wait_s=lat_full, shadow=sampler)
        arrivals = np.cumsum(rng.exponential(lat1 / 0.5, size=n_req))
        handles, i, t0 = [], 0, time.perf_counter()
        while i < n_req:
            now = time.perf_counter() - t0
            if now >= arrivals[i]:
                handles.append(queue.submit(q_pool[i % len(q_pool)],
                                            timeout_s=50.0 * slo_s))
                i += 1
            elif not queue.pump():
                time.sleep(min(arrivals[i] - now, 2e-4))
        queue.drain(timeout=120.0)
        wall = time.perf_counter() - t0
        sampler.drain(timeout_s=60.0)
        ok = [h.latency_s for h in handles if h.verdict == "ok"]
        return {"ops": {"qps": len(ok) / wall,
                        "p99_ub_s": float(np.percentile(ok, 99))
                        if ok else None},
                "report": rep.collect(engine=engine, sampler=sampler,
                                      queue=queue)}

    ob.reset()
    ob.enable()
    tuner = at.Autotuner(
        serve_window,
        [at.Knob("n_probes", probes), at.Knob("batch_cap", caps, start=8)],
        slo={"p99_s": 5.0 * slo_s, "recall_floor": floor}, settle=3,
        max_windows=10, deadline_s=60.0)
    stats = tuner.run()
    front = tuner.frontier()
    ob.disable()
    bad = sum(len(ex.validate(w["explain"])) for w in tuner.windows())
    meets = [w["proposal"]["meets_slo"] for w in tuner.windows()]
    return stats, front, bad, meets, floor, ladder


def test_tiny_tuners_meet_their_slo_on_both_packages():
    rng = np.random.default_rng(17)
    data = rng.standard_normal((1500, 16)).astype(np.float32)
    q_pool = rng.standard_normal((80, 16)).astype(np.float32)
    out = {name: _tiny_tuner_run(pkg, data, q_pool)
           for name, pkg in (("jax", JAX), ("port", PORT))}
    for name, (stats, front, bad, meets, floor, ladder) in out.items():
        assert stats["converged"], (name, stats, meets, floor, ladder)
        assert meets[-1] and stats["windows"] >= 3, (name, meets)
        assert bad == 0 and front["pareto_points"] >= 1, name
    # the calibrated floors sit in the same ladder gap
    assert abs(out["jax"][4] - out["port"][4]) <= 0.1


def test_tier_actuator_demotes_and_restores_a_capacity_tenant(tmp_path):
    """A ``KnobActuator`` over a ``CapacityController`` tenant's tier: a hot
    tick demotes it (HOT → WARM, served degraded from its IVF-BQ twin), the
    cool ticks promote it back to its tuned HOT rung."""
    from raft_tpu_torch.serving import capacity as tcap

    rng = np.random.default_rng(1)
    X = rng.standard_normal((1500, 16)).astype(np.float32)
    idx = tfl.build(X, tfl.IvfFlatParams(n_lists=16), device="cpu")
    cap = tcap.CapacityController(budget_bytes=1 << 30, device="cpu")
    cap.register("t", idx, str(tmp_path))
    ladder = [tcap.COLD, tcap.WARM, tcap.HOT]

    def set_tier(tier):
        if ladder.index(tier) < ladder.index(cap.registry.get("t").tier):
            cap.demote("t")
        else:
            cap.promote("t")

    tobs.enable()
    act = tsv.KnobActuator("tier", ladder,
                           lambda: cap.registry.get("t").tier, set_tier)
    ctrl = tsv.BurnRateController(_Engine(_hot(), _cool(), _cool()), [act],
                                  cool_windows=2, deadline_s=5.0)
    assert ctrl.pump()["actions"][0]["to"] == tcap.WARM
    res = cap.search("t", X[:3], 5, n_probes=8)
    assert res.tier == tcap.WARM and res.degraded
    assert ctrl.pump()["actions"] == []
    assert ctrl.pump()["actions"][0] == {"knob": "tier", "frm": tcap.WARM,
                                         "to": tcap.HOT, "action": "revert",
                                         "reason": "cool"}
    res = cap.search("t", X[:3], 5, n_probes=8)
    assert res.tier == tcap.HOT and not res.degraded
    np.testing.assert_array_equal(np.asarray(res.indices.cpu())[:, 0],
                                  np.arange(3))
