"""The generators give the same rows and queries for the same seeds, the
same rows whatever the run's seed, and fresh queries for another."""

import pytest
import torch

from cardbench.harness import ROOT, load_module


def _recipe(name):
    return load_module(ROOT / "cardbench" / "data" / f"{name}.py",
                       "data_" + name)


@pytest.mark.parametrize("recipe,spec", [
    ("sift_like", {"seed": 0, "rows": 3000, "dim": 128}),
    ("deep_like", {"seed": 0, "rows": 3000, "dim": 96}),
])
def test_same_seed_same_rows(recipe, spec):
    make = _recipe(recipe).make
    rows, queries = make(spec, 50, 2**31 + 7, torch.device("cpu"))
    rows2, queries2 = make(spec, 50, 2**31 + 7, torch.device("cpu"))
    rows3, queries3 = make(spec, 50, 8, torch.device("cpu"))
    assert rows.shape == (3000, spec["dim"]) and queries.shape[0] == 50
    assert torch.equal(rows, rows2) and torch.equal(queries, queries2)
    assert torch.equal(rows, rows3) and not torch.equal(queries, queries3)
    other = make({**spec, "seed": 1}, 50, 8, torch.device("cpu"))[0]
    assert not torch.equal(rows, other)


def test_sift_like_is_uint8_and_deep_like_is_unit():
    sift, _ = _recipe("sift_like").make({"seed": 3, "rows": 2000, "dim": 128},
                                        10, 1, torch.device("cpu"))
    assert sift.dtype == torch.uint8 and int(sift.max()) <= 255
    deep, _ = _recipe("deep_like").make({"seed": 3, "rows": 2000, "dim": 96},
                                        10, 1, torch.device("cpu"))
    assert torch.allclose(deep.norm(dim=1), torch.ones(2000), atol=1e-5)


def test_deep_like_rows_are_addressable_by_id():
    mod = _recipe("deep_like")
    ids = torch.arange(100)
    whole = mod.deep_like_rows(ids, 96, 5)
    part = mod.deep_like_rows(ids[37:41], 96, 5)
    assert torch.equal(whole[37:41], part)


def test_stratified_draws_each_component_as_often_whatever_the_seed():
    from cardbench.data import stratified

    w = 1.0 / torch.arange(1, 51, dtype=torch.float64) ** 0.7
    w = w / w.sum()
    counts = []
    for seed in (1, 2**31 + 3):
        g = torch.Generator()
        g.manual_seed(seed)
        c = stratified(w, 1003, g)
        assert c.shape == (1003,)
        counts.append(torch.bincount(c, minlength=50))
    assert torch.equal(counts[0], counts[1])
    assert int(counts[0].sum()) == 1003
    assert float((counts[0] - w * 1003).abs().max()) < 1.0


def test_the_run_seed_draws_the_query_pool(tmp_path):
    from cardbench import harness
    from cardbench.tests.tiny import make_root

    root = make_root(tmp_path)
    cell = harness.load_cell(root, "sift1m-ivfpq.b10k")
    pools = [harness.Run(cell, seed, 0.0, False, torch.device("cpu"), root,
                         0.0).data(40) for seed in (7, 7, 8)]
    assert torch.equal(pools[0][0], pools[2][0])
    assert torch.equal(pools[0][1], pools[1][1])
    assert not torch.equal(pools[0][1], pools[2][1])
