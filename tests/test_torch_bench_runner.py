"""The bench runner entry point of the port — ``random``,
``bench/datasets.data_dir``, ``bench/io`` and ``bench/runner`` — held
against the JAX package.

* ``bench/io``: a file written by either package is byte-identical to the
  other's, for every TEXMEX and big-ann format; both read each other's
  files to equal arrays; directory discovery agrees; ground truth from the
  port's brute force equals the JAX package's.
* ``random``: ``jax.random`` streams cannot be reproduced in torch, so the
  generators are held by invariants, each with its stated tolerance.
* ``bench/runner``: one tiny ``siftlike`` config through both runners gives
  the same record keys and order and per-record recall within 0.005; the
  other dataset kinds and the CLI run on the port.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raft_tpu.bench import datasets as jds
from raft_tpu.bench import io as jio
from raft_tpu.bench import runner as jrun
from raft_tpu_torch import random as trand
from raft_tpu_torch.bench import datasets as tds
from raft_tpu_torch.bench import io as tio
from raft_tpu_torch.bench import runner as trun

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"

#: the runner's recall agreement between the packages (each builds its own
#: quantizer from its own random stream)
RECALL_TOL = 0.005


# ---------------------------------------------------------------------------
# bench/io
# ---------------------------------------------------------------------------

_FORMATS = [(".fvecs", np.float32), (".ivecs", np.int32),
            (".bvecs", np.uint8), (".fbin", np.float32),
            (".u8bin", np.uint8), (".i8bin", np.int8), (".ibin", np.int32)]


def _array(dtype, rng, shape=(37, 24)):
    if dtype == np.float32:
        return rng.normal(size=shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -1000), min(info.max, 1000) + 1,
                        size=shape).astype(dtype)


@pytest.mark.parametrize("ext,dtype", _FORMATS, ids=[e for e, _ in _FORMATS])
def test_io_files_are_byte_identical_both_ways(tmp_path, ext, dtype):
    rng = np.random.default_rng(len(ext))
    arr = _array(dtype, rng)
    written = {}
    for name, mod in (("jax", jio), ("port", tio)):
        path = tmp_path / f"{name}{ext}"
        (mod.write_vecs if "vecs" in ext else mod.write_bin)(path, arr)
        written[name] = path
    assert written["jax"].read_bytes() == written["port"].read_bytes()
    for path in written.values():
        for mod in (jio, tio):
            np.testing.assert_array_equal(mod.read_any(path), arr)
            np.testing.assert_array_equal(mod.read_any(path, 5), arr[:5])
    # float input is cast to the extension's dtype by both writers
    for name, mod in (("jax", jio), ("port", tio)):
        path = tmp_path / f"cast_{name}{ext}"
        (mod.write_vecs if "vecs" in ext else mod.write_bin)(
            path, arr.astype(np.float64))
    assert (tmp_path / f"cast_jax{ext}").read_bytes() == \
        (tmp_path / f"cast_port{ext}").read_bytes()


def test_io_errors_and_npy_match_the_jax_readers(tmp_path):
    bad = tmp_path / "bad.fvecs"
    bad.write_bytes(b"\x04\x00\x00\x00" + b"\x00" * 10)   # dim 4, short row
    short = tmp_path / "short.fbin"
    short.write_bytes(np.array([5, 4], np.int32).tobytes() + b"\x00" * 12)
    unknown = tmp_path / "x.csv"
    unknown.write_text("1,2\n")
    for path, match in ((bad, "row size"), (short, "truncated"),
                        (unknown, "unknown dataset file format")):
        for mod in (jio, tio):
            with pytest.raises(ValueError, match=match):
                mod.read_any(path)
    arr = np.arange(60, dtype=np.float32).reshape(12, 5)
    np.save(tmp_path / "a.npy", arr)
    np.testing.assert_array_equal(tio.read_any(tmp_path / "a.npy", 3),
                                  jio.read_any(tmp_path / "a.npy", 3))


def test_hdf5_reader_imports_h5py_lazily(tmp_path):
    """``h5py`` is imported only when an HDF5 bundle is read."""
    code = ("import sys\nimport raft_tpu_torch.bench.io\n"
            "assert 'h5py' not in sys.modules\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    h5py = pytest.importorskip(
        "h5py", reason="h5py is not installed, so no HDF5 bundle can be "
                       "written to read back (read_hdf5 imports it lazily)")
    rng = np.random.default_rng(3)
    p = tmp_path / "toy.hdf5"
    with h5py.File(p, "w") as f:
        f["train"] = rng.normal(size=(50, 8)).astype(np.float32)
        f["test"] = rng.normal(size=(5, 8)).astype(np.float32)
        f["neighbors"] = rng.integers(0, 50, size=(5, 10))
    got, want = tio.read_hdf5(p), jio.read_hdf5(p)
    assert sorted(got) == sorted(want)
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])


def test_dataset_discovery_agrees(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    sift = tmp_path / "sift"
    sift.mkdir()
    base = rng.integers(0, 255, size=(64, 32)).astype(np.float32)
    tio.write_vecs(sift / "sift_base.fvecs", base)
    jio.write_vecs(sift / "sift_query.fvecs", base[:7])
    tio.write_vecs(sift / "sift_groundtruth.ivecs",
                   rng.integers(0, 64, size=(7, 10)).astype(np.int32))
    deep = tmp_path / "deep"
    deep.mkdir()
    jio.write_bin(deep / "base.u8bin",
                  rng.integers(0, 255, (16, 8)).astype(np.uint8))
    tio.write_bin(deep / "query.u8bin",
                  rng.integers(0, 255, (3, 8)).astype(np.uint8))
    for name, rows in (("sift", None), ("sift", 20), ("deep", None),
                       ("nope", None)):
        got = tio.load_real_dataset(tmp_path, name, rows)
        want = jio.load_real_dataset(tmp_path, name, rows)
        if want is None:
            assert got is None
            continue
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)
    monkeypatch.setenv("RAFT_TPU_DATA_DIR", str(tmp_path))
    assert tds.data_dir() == jds.data_dir() == str(tmp_path)
    monkeypatch.delenv("RAFT_TPU_DATA_DIR")
    assert tds.data_dir() == jds.data_dir()


def test_groundtruth_equals_the_jax_tool():
    rng = np.random.default_rng(9)
    X = rng.normal(size=(700, 12)).astype(np.float32)
    Q = rng.normal(size=(33, 12)).astype(np.float32)
    for metric in ("sqeuclidean", "inner_product"):
        ids, d = tio.generate_groundtruth(X, Q, k=7, metric=metric, batch=8,
                                          device=CPU)
        jids, jd = jio.generate_groundtruth(X, Q, k=7, metric=metric,
                                            batch=8)
        assert isinstance(ids, np.ndarray) and ids.dtype == np.int32
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# random: invariants
# ---------------------------------------------------------------------------


def test_permutation_and_samples_without_replacement():
    for seed in range(5):
        p = trand.permute(seed, 1000, device=CPU)
        assert p.dtype == torch.int32
        assert torch.equal(torch.sort(p).values,
                           torch.arange(1000, dtype=torch.int32))
        s = trand.sample_without_replacement(seed, 500, 200, device=CPU)
        assert s.dtype == torch.int32 and len(set(s.tolist())) == 200
        assert 0 <= int(s.min()) and int(s.max()) < 500
    # a seed gives one stream; an RngState splits into different streams
    assert torch.equal(trand.permute(3, 50, device=CPU),
                       trand.permute(3, 50, device=CPU))
    state = trand.RngState(3)
    assert not torch.equal(trand.permute(state, 50, device=CPU),
                           trand.permute(state, 50, device=CPU))
    with pytest.raises(ValueError):
        trand.sample_without_replacement(0, 5, 6, device=CPU)
    # the whole population is a permutation of it
    full = trand.sample_without_replacement(1, 64, 64, device=CPU)
    assert sorted(full.tolist()) == list(range(64))


def test_blob_means_sit_on_their_centres():
    """Each blob's sample mean is within 4 standard errors
    (4·cluster_std/√count) of its centre on every coordinate, its spread is
    cluster_std within 10%, and the centres lie in the centre box."""
    data, labels, centers = trand.make_blobs(
        11, 20_000, 8, n_clusters=6, cluster_std=0.7,
        center_box=(-5.0, 5.0), device=CPU)
    assert data.shape == (20_000, 8) and labels.dtype == torch.int32
    assert centers.shape == (6, 8)
    assert float(centers.min()) >= -5.0 and float(centers.max()) <= 5.0
    for c in range(6):
        rows = data[labels == c]
        assert rows.shape[0] > 2_000
        se = 0.7 / rows.shape[0] ** 0.5
        assert float((rows.mean(0) - centers[c]).abs().max()) < 4 * se
        assert abs(float(rows.std(0).mean()) - 0.7) < 0.07
    given = torch.tensor([[0.0, 0.0], [10.0, 10.0]])
    d2, l2, c2 = trand.make_blobs(0, 100, 2, centers=given, device=CPU)
    assert torch.equal(c2, given) and set(l2.tolist()) <= {0, 1}


def test_gaussian_sample_covariance_is_near_cov():
    """The sample covariance of 40,000 draws is within 0.05 of ``cov`` on
    every entry (the standard error of an entry here is ≤ 0.014), the
    sample mean within 0.05 of ``mean``."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(4, 4))
    cov = a @ a.T / 4 + 0.5 * np.eye(4)
    mean = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    x = trand.multi_variable_gaussian(5, torch.from_numpy(mean), cov, 40_000,
                                      device=CPU)
    assert x.dtype == torch.float32 and x.shape == (40_000, 4)
    xs = x.double().numpy()
    assert np.abs(np.cov(xs.T) - cov).max() < 0.05
    assert np.abs(xs.mean(0) - mean).max() < 0.05


def test_rmat_quadrant_shares_are_near_theta():
    """At every level the share of edges in each quadrant is within 0.01 of
    θ (50,000 edges: the standard error is ≤ 0.0023), and ids stay in the
    rectangle; a custom θ is normalised."""
    n_edges, r_scale, c_scale = 50_000, 6, 4
    rows, cols = trand.rmat(7, r_scale, c_scale, n_edges, device=CPU)
    assert rows.dtype == torch.int32 and cols.dtype == torch.int32
    assert int(rows.max()) < 2 ** r_scale and int(cols.max()) < 2 ** c_scale
    theta = np.array([0.57, 0.19, 0.19, 0.05])
    r, c = rows.numpy(), cols.numpy()
    for lvl in range(c_scale):
        rb = (r >> (r_scale - 1 - lvl)) & 1
        cb = (c >> (c_scale - 1 - lvl)) & 1
        shares = np.bincount(2 * rb + cb, minlength=4) / n_edges
        assert np.abs(shares - theta).max() < 0.01, (lvl, shares)
    # levels past the column scale set only the row bit: (a + b) vs (c + d)
    for lvl in range(c_scale, r_scale):
        rb = (r >> (r_scale - 1 - lvl)) & 1
        assert abs(rb.mean() - 0.24) < 0.01
    custom = np.tile([[2.0, 1.0, 1.0, 0.0]], (3, 1))
    r2, c2 = trand.rmat(1, 3, 3, 20_000, theta=custom, device=CPU)
    top = ((r2.numpy() >> 2) & 1) * 2 + ((c2.numpy() >> 2) & 1)
    shares = np.bincount(top, minlength=4) / 20_000
    assert np.abs(shares - [0.5, 0.25, 0.25, 0.0]).max() < 0.015


def test_uniform_normal_and_regression():
    u = trand.uniform(0, (50_000,), low=-2.0, high=3.0, device=CPU)
    assert float(u.min()) >= -2.0 and float(u.max()) < 3.0
    assert abs(float(u.mean()) - 0.5) < 0.03
    z = trand.normal(1, (50_000,), mean=4.0, std=2.0, device=CPU)
    assert abs(float(z.mean()) - 4.0) < 0.05 and abs(float(z.std()) - 2) < 0.05
    x, y, coef = trand.make_regression(3, 500, 6, n_informative=3, bias=1.5,
                                       device=CPU)
    assert x.shape == (500, 6) and y.shape == (500,) and coef.shape == (6,)
    assert torch.all(coef[3:] == 0) and torch.all(coef[:3] >= 0)
    assert torch.allclose(y, x @ coef + 1.5, atol=1e-3)
    _, yn, _ = trand.make_regression(3, 500, 6, n_targets=2, noise=1.0,
                                     device=CPU)
    assert yn.shape == (500, 2)


def test_generators_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: trand.permute(0, 4),
                 lambda: trand.make_blobs(0, 4, 2),
                 lambda: trand.rmat(0, 2, 2, 4),
                 lambda: tio.generate_groundtruth(np.zeros((4, 2)),
                                                  np.zeros((1, 2)), k=1),
                 lambda: trun.run_benchmark(_CONFIG)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

_CONFIG = {
    "dataset": {"kind": "siftlike", "n": 5000, "dim": 32, "n_queries": 1000,
                "seed": 0},
    "k": 10,
    "algos": [
        {"name": "brute_force", "build": {}, "search": [{}]},
        {"name": "ivf_flat", "build": {"n_lists": 16},
         "search": [{"n_probes": 4}]},
        {"name": "ivf_pq", "build": {"n_lists": 16, "pq_dim": 16},
         "search": [{"n_probes": 4, "refine_ratio": 2}]},
    ],
}


def test_runners_agree_on_a_tiny_siftlike_config():
    got = trun.run_benchmark(_CONFIG, reps=1, device=CPU)
    want = jrun.run_benchmark(json.loads(json.dumps(_CONFIG)), reps=1)
    assert [list(r) for r in got] == [list(r) for r in want]
    assert [(r["algo"], r["search_params"], r["build_params"], r["k"])
            for r in got] == \
        [(r["algo"], r["search_params"], r["build_params"], r["k"])
         for r in want]
    for g, w in zip(got, want):
        assert abs(g["recall"] - w["recall"]) <= RECALL_TOL, (g, w)
        assert g["qps"] > 0 and g["build_s"] >= 0
    assert got[0]["algo"] == "brute_force" and got[0]["recall"] == 1.0


def test_runner_cli_other_dataset_kinds_and_errors(tmp_path, monkeypatch,
                                                   capsys):
    rng = np.random.default_rng(1)
    base = rng.normal(size=(600, 8)).astype(np.float32)
    tio.write_vecs(tmp_path / "base.fvecs", base)
    np.save(tmp_path / "q.npy", base[:20] + 0.01)
    files = {"dataset": {"kind": "files", "base": str(tmp_path / "base.fvecs"),
                         "queries": str(tmp_path / "q.npy")},
             "k": 5, "metric": "inner_product",
             "algos": [{"name": "ivf_flat", "build": {"n_lists": 4},
                        "search": [{"n_probes": 4}]}]}
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(files))
    out = tmp_path / "out.json"
    assert trun.main([str(cfg), "-o", str(out), "--reps", "1",
                      "--device", CPU]) is None      # as JAX's main
    records = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == records
    assert records[0]["recall"] == 1.0
    assert records[0]["build_params"]["metric"] == "inner_product"
    blobs = {"dataset": {"kind": "blobs", "n": 800, "dim": 8,
                         "n_queries": 30, "n_clusters": 8},
             "k": 5, "algos": [{"name": "brute_force"}]}
    assert trun.run_benchmark(blobs, reps=1, device=CPU)[0]["recall"] == 1.0
    sift = tmp_path / "sift"
    sift.mkdir()
    tio.write_vecs(sift / "sift_base.fvecs", base)
    tio.write_vecs(sift / "sift_query.fvecs", base[:10])
    monkeypatch.setenv("RAFT_TPU_DATA_DIR", str(tmp_path))
    real = {"dataset": {"kind": "real", "name": "sift", "max_rows": 300},
            "k": 3, "algos": [{"name": "brute_force"}]}
    assert trun.run_benchmark(real, reps=1, device=CPU)[0]["recall"] == 1.0
    with pytest.raises(FileNotFoundError):
        trun.run_benchmark(dict(real, dataset={"kind": "real",
                                               "name": "gist"}), device=CPU)
    with pytest.raises(ValueError, match="unknown dataset kind"):
        trun.run_benchmark(dict(blobs, dataset={"kind": "nope"}), device=CPU)
    with pytest.raises(ValueError, match="unknown algo"):
        trun.run_benchmark(dict(blobs, algos=[{"name": "hnsw"}]), device=CPU)
    with pytest.raises(ValueError, match="sqeuclidean only"):
        trun.run_benchmark(dict(blobs, metric="cosine",
                                algos=[{"name": "cagra"}]), device=CPU)
    proc = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.bench.runner", str(cfg),
         "--reps", "1", "--device", CPU], cwd=REPO, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, RAFT_TPU_DATA_DIR=""))
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)[0]["algo"] == "ivf_flat"
