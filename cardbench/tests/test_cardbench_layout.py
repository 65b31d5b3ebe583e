"""``BENCHMARK.json`` keeps to its contract, and the harness finds a cell's
configuration, traffic mix and per-layer metric by name: a new cell is new
files and new entries, with no existing file edited."""

import hashlib
import json
import re

import pytest

from cardbench import harness
from cardbench.tests.tiny import REPO, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _spec():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_to_its_contract():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["cardbench"]
    assert spec["command"] == ["python3", "cardbench/run.py"]
    rs = spec["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert c["file"].startswith("cardbench/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert (REPO / "cardbench" / "data"
                / f"{cfg['data']['recipe']}.py").is_file()
    cells = {w["name"]: w for w in spec["workloads"]}
    assert len(cells) == len(spec["workloads"])
    assert len({(w["config"], w["traffic"]) for w in spec["workloads"]}) \
        == len(cells)
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] == 1
        assert 0 < len(w["why"]) <= 200
        tr = json.loads((REPO / "cardbench" / "traffic"
                         / f"{w['traffic']}.json").read_text())
        assert (REPO / "cardbench" / "loops" / f"{tr['loop']}.py").is_file()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in SOURCES and m["moves"] in e2e
        reader = harness.load_module(harness.metric_file(REPO, m["name"]),
                                     m["name"])
        assert callable(reader.read)
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
    for w in cells:
        cell = harness.load_cell(REPO, w)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def _hashes(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "cardbench").rglob("*") if p.is_file()}


def test_a_new_cell_is_found_by_name_without_editing_a_file(tmp_path):
    root = make_root(tmp_path)
    before = _hashes(root)
    cfg = json.loads((root / "cardbench/configs/sift1m-ivfpq.json")
                     .read_text())
    cfg.update(name="tiny-ivfpq", reduced=["rows"])
    cfg["data"]["rows"] = 3000
    (root / "cardbench/configs/tiny-ivfpq.json").write_text(json.dumps(cfg))
    (root / "cardbench/traffic/b100.json").write_text(json.dumps(
        {"loop": "search_closed", "batch": 100, "pool_batches": 5,
         "check_sample": 2, "why": "a test's mix"}))
    (root / "cardbench/metrics/requests_traced.py").write_text(
        "def read(trace):\n"
        "    return float(len(trace.layer_ms.get('request', [])))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-ivfpq",
                            "source": "a test", "reduced": ["rows"],
                            "file": "cardbench/configs/tiny-ivfpq.json",
                            "why": "a test"})
    spec["workloads"].append({"name": "tiny-ivfpq.b100",
                              "config": "tiny-ivfpq", "traffic": "b100",
                              "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "sift1m-ivfpq.b10k" in m["workloads"]:
            m["workloads"].append("tiny-ivfpq.b100")
    spec["per_layer"].append({"name": "requests_traced", "unit": "requests",
                              "better": "higher", "source": "device_trace",
                              "layer": "device", "moves": "qps.host_paced",
                              "workloads": ["tiny-ivfpq.b100"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _hashes(root)
    assert all(after[p] == h for p, h in before.items())
    line = harness.run_cell(root, "tiny-ivfpq.b100", 11, 0.3, True,
                            device="cpu")
    assert line["correct"], line["checks"]
    assert list(line["metrics"]) == ["requests_traced"]
    assert line["metrics"]["requests_traced"]["value"] >= 1


@pytest.mark.parametrize("extra", [{"clients": 2}, {"arrival_rate": 100}])
def test_a_traffic_key_the_loop_does_not_read_is_an_error(tmp_path, extra):
    root = make_root(tmp_path)
    f = root / "cardbench/traffic/b10k.json"
    f.write_text(json.dumps({**json.loads(f.read_text()), **extra}))
    with pytest.raises(ValueError):
        harness.run_cell(root, "sift1m-ivfpq.b10k", 3, 0.1, False,
                         device="cpu")


def test_a_qualified_metric_falls_back_to_its_quantity():
    files = {"search_ms", "idle_share", "idle_share.build"}
    assert harness.qualified("search_ms.host_paced", files.__contains__) \
        == "search_ms"
    assert harness.qualified("idle_share.build", files.__contains__) \
        == "idle_share.build"
    assert harness.qualified("idle_share.search", files.__contains__) \
        == "idle_share"
    assert harness.qualified("p95_ms.host_paced", files.__contains__) is None
