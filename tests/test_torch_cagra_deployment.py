"""CAGRA as the benchmark's ``sift1m-cagra`` deploys it, at a CPU test's
size: the port's build (the configuration's degrees, 128 → 64, with the
compression payload on) and search (its itopk and width) on the
benchmark's own SIFT-shaped uint8 rows, held to the benchmark's plain
reference (``cardbench/reference/knn.py``), and the spans and counters
the traced cell reads."""

import json

import pytest
import torch

from cardbench.harness import ROOT, load_module
from cardbench.reference import judge, knn
from raft_tpu_torch import obs
from raft_tpu_torch.neighbors import cagra

torch.set_num_threads(2)
CPU = {"device": "cpu"}
CONFIG = json.loads((ROOT / "cardbench" / "configs" / "sift1m-cagra.json")
                    .read_text())
SEARCH = {k: v for k, v in CONFIG["search"].items() if k != "k"}
K = CONFIG["search"]["k"]
N_QUERIES = 512


@pytest.fixture(scope="module")
def deployment():
    make = load_module(ROOT / "cardbench" / "data" / "sift_like.py",
                       "data_sift_like").make
    rows, queries = make({**CONFIG["data"], "rows": 20_000}, N_QUERIES,
                         2**31 + 17, torch.device("cpu"))
    # compress="auto" starts at 200k rows
    index = cagra.build(rows, cagra.CagraParams(
        **{**CONFIG["index"], "compress": "on"}, seed=5), **CPU)
    gt_d, _ = knn.exact_knn(rows, queries, K)
    return rows, queries, index, gt_d


@pytest.fixture
def telemetry():
    obs.reset()
    obs.clear_spans()
    yield
    obs.disable()
    obs.reset()
    obs.clear_spans()


def _search(index, queries, traversal, stats=None):
    return cagra.search(index, queries, K, cagra.CagraSearchParams(
        **{**SEARCH, "traversal": traversal}), stats=stats, **CPU)


@pytest.fixture(scope="module")
def answers(deployment):
    _, queries, index, _ = deployment
    out = {}
    for traversal in ("auto", "fused"):
        st = {}
        d, ids = _search(index, queries, traversal, st)
        out[traversal] = (d, ids, st)
    return out


def test_auto_and_fused_are_one_traversal(answers):
    assert answers["auto"][2]["mode"] == "compressed"
    assert answers["fused"][2]["mode"] == "fused"
    assert torch.equal(answers["auto"][1], answers["fused"][1])
    assert torch.equal(answers["auto"][0], answers["fused"][0])


@pytest.mark.parametrize("traversal", ["auto", "fused"])
def test_recall_against_the_plain_reference(deployment, answers, traversal):
    rows, queries, _, gt_d = deployment
    _, ids, _ = answers[traversal]
    hits = judge.recall_hits(rows, queries, ids.to(torch.int64),
                             gt_d[:, K - 1])
    assert hits / ids.numel() >= 0.95


@pytest.mark.parametrize("traversal", ["auto", "fused"])
def test_every_distance_is_exact_and_every_id_well_formed(deployment, answers,
                                                          traversal):
    rows, queries, _, _ = deployment
    d, ids, _ = answers[traversal]
    ids = ids.to(torch.int64)
    assert judge.malformed_ids(ids, rows.shape[0]) == 0
    assert bool((ids >= 0).all())
    assert judge.malformed_dists(d, ids) == 0
    ref = knn.exact_distances(rows, queries, ids)
    assert torch.equal(d.to(torch.float64), ref)


def test_the_fused_loop_records_its_spans_and_counts_its_hops(
        deployment, telemetry, monkeypatch):
    _, queries, index, _ = deployment
    calls = []
    twin = cagra.fused_hop

    def counted(*a, **kw):
        calls.append(1)
        return twin(*a, **kw)

    monkeypatch.setattr(cagra, "fused_hop", counted)
    obs.enable()
    st = {}
    _search(index, queries, "fused", st)
    obs.registry().settle()
    counters = obs.snapshot()["counters"]
    names = {s["name"] for s in obs.spans()}
    assert {"cagra::search", "cagra::seed", "cagra::hop",
            "cagra::finish"} <= names
    hops = sum(st["hops"])
    assert hops >= 1
    assert counters["cagra.search.hops"] == hops == len(calls)
    assert counters["cagra.k6.launches"] == hops
    assert counters["cagra.search.frontier_checks"] >= 1
    launched = counters["cagra.k6.parents_launched"]
    assert launched == N_QUERIES * SEARCH["search_width"] * hops
    assert 0 < counters["cagra.k6.parents_live"] <= launched


def test_the_compressed_loop_records_its_seed_and_finish(deployment,
                                                         telemetry):
    _, queries, index, _ = deployment
    obs.enable()
    _search(index, queries[:64], "compressed")
    names = {s["name"] for s in obs.spans()}
    assert {"cagra::seed", "cagra::finish"} <= names
    assert "cagra::hop" not in names


@pytest.mark.parametrize("traversal", ["compressed", "fused"])
def test_with_telemetry_off_nothing_moves(deployment, telemetry, traversal):
    _, queries, index, _ = deployment
    obs.disable()
    _search(index, queries[:64], traversal)
    obs.registry().settle()
    snap = obs.snapshot()
    assert snap["counters"] == {} and snap["timers"] == {}
    assert obs.spans() == []
