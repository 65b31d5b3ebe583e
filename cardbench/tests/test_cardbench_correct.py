"""The comparison that decides ``correct`` fails what it must: the control
(the reference in the program's place at the precision below the
configuration's), and the run with its timed path broken underneath (half
of each batch left out, an answer altered where it is produced, a build
over half the rows). The look for a card is skipped; the rest of the run
is driven as on the card, at a size a CPU test run holds."""

import pytest

from cardbench import control, harness
from cardbench.tests.tiny import make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("correct"))


def _run(root, workload, seed=2**31 + 11):
    return harness.run_cell(root, workload, seed, 0.3, False, device="cpu")


@pytest.mark.parametrize("workload", ["sift1m-ivfpq.b10k",
                                      "sift1m-ivfpq.b10k-filter10",
                                      "deep10m-ivfpq.b10k",
                                      "sift1m-ivfpq.build"])
def test_sound_runs_are_correct(root, workload):
    line = _run(root, workload)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("workload", ["sift1m-ivfpq.b10k",
                                      "sift1m-ivfpq.b10k-filter10",
                                      "deep10m-ivfpq.b10k"])
def test_control_is_not_correct(root, workload):
    got = control.control_run(root, workload, 5, device="cpu")
    assert got["correct"] is False, got
    assert got["checks"]["dist_err"] > 0


def _half_left_out(refine):
    def broken(dataset, queries, candidates, k, **kw):
        d, ids = refine(dataset, queries, candidates, k, **kw)
        h = ids.shape[0] // 2
        d[h:], ids[h:] = d[:ids.shape[0] - h].clone(), ids[:ids.shape[0] - h].clone()
        return d, ids
    return broken


def _answer_altered(refine):
    def broken(dataset, queries, candidates, k, **kw):
        d, ids = refine(dataset, queries, candidates, k, **kw)
        ids[0, 0] = (ids[0, 0] + 1) % dataset.shape[0]
        return d, ids
    return broken


@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered])
@pytest.mark.parametrize("workload", ["sift1m-ivfpq.b10k",
                                      "deep10m-ivfpq.b10k",
                                      "sift1m-ivfpq.build"])
def test_broken_answers_are_not_correct(root, workload, fault, monkeypatch):
    from raft_tpu_torch.neighbors import refine

    monkeypatch.setattr(refine, "refine", fault(refine.refine))
    line = _run(root, workload)
    assert line["correct"] is False, line["checks"]


def test_build_over_half_the_rows_is_not_correct(root, monkeypatch):
    from raft_tpu_torch.neighbors import ivf_pq

    build = ivf_pq.build

    def broken(dataset, params, **kw):
        return build(dataset[:dataset.shape[0] // 2], params, **kw)

    monkeypatch.setattr(ivf_pq, "build", broken)
    line = _run(root, "sift1m-ivfpq.build")
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["recall_at_10"]["value"] < 0.7
