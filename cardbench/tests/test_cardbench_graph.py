"""The graph-search loop (``loops/graph_closed.py``), the K6 yardstick and
the CAGRA cell's readers: the loop runs ``correct`` on the CPU against a
tiny copy of ``sift1m-cagra`` added as new files only, the yardstick
matches a hand count, and every reader returns None where it finds
nothing to read."""

import json

import pytest

from cardbench import harness
from cardbench.roofline import cagra_hop
from cardbench.tests.tiny import REPO, make_root
from cardbench.trace import Trace

READERS = ["cagra.search_ms", "cagra.seed_ms", "cagra.hop_ms",
           "cagra.finish_ms", "k6_roofline", "k6_live_share"]


def _reader(name):
    return harness.load_module(harness.metric_file(REPO, name),
                               "metric_" + name)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tiny copy of the benchmark with ``tiny-cagra``: sift1m-cagra at
    6,000 rows, its payload on (``compress="auto"`` starts at 200k rows),
    under the cagra-b10k traffic cut to batches of 200."""
    root = make_root(tmp_path_factory.mktemp("graph"))
    cfg = json.loads((REPO / "cardbench/configs/sift1m-cagra.json")
                     .read_text())
    cfg.update(name="tiny-cagra", reduced=["rows", "index"])
    cfg["data"]["rows"] = 6000
    cfg["index"]["compress"] = "on"
    (root / "cardbench/configs/tiny-cagra.json").write_text(json.dumps(cfg))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-cagra", "source": "a test",
                            "reduced": cfg["reduced"],
                            "file": "cardbench/configs/tiny-cagra.json",
                            "why": "a test"})
    spec["workloads"].append({"name": "tiny-cagra.b10k",
                              "config": "tiny-cagra", "traffic": "cagra-b10k",
                              "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "sift1m-cagra.b10k" in m.get("workloads", []):
            m["workloads"].append("tiny-cagra.b10k")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_graph_closed_runs_correct_on_the_cpu(root, trace):
    line = harness.run_cell(root, "tiny-cagra.b10k", 2**31 + 29, 0.3,
                            bool(trace), device="cpu")
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert line["checks"]["dist_err"]["value"] == 0.0
    cell = harness.load_cell(root, "tiny-cagra.b10k")
    if trace:
        # the CPU takes the compressed loop: no K6, no device time
        assert set(line["metrics"]) == {"cagra.search_ms"}
        assert line["metrics"]["cagra.search_ms"]["value"] > 0
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("extra", [{"clients": 2}, {"filter_pass": 0.1}])
def test_a_traffic_key_graph_closed_does_not_read_is_an_error(root, extra):
    f = root / "cardbench/traffic/cagra-b10k.json"
    before = f.read_text()
    f.write_text(json.dumps({**json.loads(before), **extra}))
    try:
        with pytest.raises(ValueError):
            harness.run_cell(root, "tiny-cagra.b10k", 3, 0.1, False,
                             device="cpu")
    finally:
        f.write_text(before)


def test_k6_work_by_hand():
    # 3 queries, 2 hops, width 2, degree 4, p 8, itopk 5: a query's hop
    # reads 8 graph ids (32 B), 8 records of 8 codes (64 B), qp (32 B) and
    # the buffer in and out (2 · 5 · 12 = 120 B): 248 B; 4 · 8 · 8 = 256
    # operations
    w = cagra_hop.work(3, 2, 2, 4, 8, 5)
    assert w == {"flops": 6 * 256.0, "bytes": 6 * 248.0}
    # the benchmark's shape: 10k queries, 16 hops, width 4, degree 64,
    # p 64, itopk 64 reads 19,200 B a query a hop
    assert cagra_hop.work(10_000, 16, 4, 64, 64, 64)["bytes"] == \
        10_000 * 16 * 19_200


@pytest.mark.parametrize("name", READERS)
def test_every_new_reader_finds_nothing_in_an_empty_trace(name):
    assert _reader(name).read(Trace()) is None


def test_the_readers_read_a_filled_trace():
    tr = Trace()
    tr.layer_ms = {"search": [4.0, 6.0]}
    tr.spans = [{"name": "cagra::seed", "count": 2, "dur_s": 0.1,
                 "device_s": 0.004},
                {"name": "cagra::hop", "count": 4, "dur_s": 0.1,
                 "device_s": 0.002},
                {"name": "cagra::finish", "count": 2, "dur_s": 0.1,
                 "device_s": None}]
    tr.device_ops = {"void cagra_hop_kernel<2>(HopParams)": 0.004,
                     "other": 1.0}
    tr.work["k6"] = {"least_s": 0.001, "counters": {
        "cagra.k6.parents_launched": 80, "cagra.k6.parents_live": 60}}
    got = {n: _reader(n).read(tr) for n in READERS}
    assert got == pytest.approx({
        "cagra.search_ms": 5.0, "cagra.seed_ms": 2.0, "cagra.hop_ms": 1.0,
        "cagra.finish_ms": None, "k6_roofline": 25.0,
        "k6_live_share": 75.0})
