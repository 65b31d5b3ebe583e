"""The hnswlib export, its reader and search, and ``refine_host`` in the
PyTorch port against the JAX package: files byte-identical to the JAX
writer's for the same JAX-built CAGRA index, the native and Python writers
identical, ``HnswIndex.knn`` equal to JAX's on one file, and the host
re-rank equal to JAX's."""

from pathlib import Path

import numpy as np
import pytest
import torch

from raft_tpu.bench.datasets import sift_like
from raft_tpu.neighbors import cagra as jc
from raft_tpu.neighbors import hnsw as jhnsw
from raft_tpu.neighbors import refine as jrefine
from raft_tpu_torch import native
from raft_tpu_torch.neighbors import cagra as tc
from raft_tpu_torch.neighbors import hnsw as thnsw
from raft_tpu_torch.neighbors import refine as trefine

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_index():
    """A JAX-built CAGRA index (exact graph) and queries."""
    data, q = sift_like(1500, 16, 20, seed=5)
    idx = jc.build(data, jc.CagraParams(intermediate_graph_degree=24,
                                        graph_degree=16))
    return idx, data.astype(np.float32), q.astype(np.float32)


@pytest.fixture(scope="module")
def files(jax_index, tmp_path_factory):
    """The JAX writer's file and the port's, for the same index carried
    across by arrays."""
    idx, _, _ = jax_index
    d = tmp_path_factory.mktemp("hnsw")
    jhnsw.save_to_hnswlib(idx, d / "jax.bin")
    carried = tc.from_jax_arrays({"kind": "cagra"},
                                 {"dataset": idx.dataset, "graph": idx.graph,
                                  "norms": idx.norms}, device="cpu")
    which = thnsw.save_to_hnswlib(carried, d / "torch.bin")
    return d / "jax.bin", d / "torch.bin", which


def test_export_is_byte_identical_to_the_jax_writers(files):
    jax_file, torch_file, which = files
    assert which in ("native", "python")
    assert torch_file.read_bytes() == jax_file.read_bytes()


def test_native_and_python_writers_write_the_same_bytes(jax_index, tmp_path):
    idx, _, _ = jax_index
    lib = native.get_native_lib()
    assert lib is not None, "g++ builds the writer here"
    graph = np.ascontiguousarray(np.asarray(idx.graph), np.uint32)
    data = np.ascontiguousarray(np.asarray(idx.dataset), np.float32)
    thnsw.write_native(lib, tmp_path / "n.bin", graph, data, 750)
    thnsw.write_python(tmp_path / "p.bin", graph, data, 750)
    assert (tmp_path / "n.bin").read_bytes() == (tmp_path / "p.bin").read_bytes()
    # the library is the port's own, built under raft_tpu_torch/_build/
    path = native.library_path()
    assert path.parent == REPO / "raft_tpu_torch" / "_build"
    assert path.exists() and path.name.startswith("libhnsw_writer-")


def test_save_names_its_writer(jax_index, tmp_path, monkeypatch):
    """The native writer where ``g++`` built it, else the Python twin, and
    the same file either way."""
    idx, _, _ = jax_index
    assert thnsw.save_to_hnswlib(idx, tmp_path / "n.bin") == "native"
    monkeypatch.setattr(native, "get_native_lib", lambda: None)
    assert thnsw.save_to_hnswlib(idx, tmp_path / "p.bin") == "python"
    assert (tmp_path / "n.bin").read_bytes() == (tmp_path / "p.bin").read_bytes()


def test_knn_ids_equal_the_jax_search_on_one_file(files, jax_index):
    jax_file, torch_file, _ = files
    _, data, q = jax_index
    j = jhnsw.HnswIndex.load(jax_file, dim=16)
    t = thnsw.HnswIndex.load(torch_file, dim=16)
    np.testing.assert_array_equal(t.graph, j.graph)
    np.testing.assert_array_equal(t.dataset, j.dataset)
    assert t.entrypoint == j.entrypoint == 750
    for ef in (16, 64):
        jd, ji = j.knn(q, 10, ef=ef)
        td, ti = t.knn(q, 10, ef=ef)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)


def test_load_refuses_what_is_not_an_export(files, tmp_path):
    jax_file, _, _ = files
    raw = jax_file.read_bytes()
    (tmp_path / "short.bin").write_bytes(raw[:40])
    with pytest.raises(ValueError, match="shorter than"):
        thnsw.HnswIndex.load(tmp_path / "short.bin", dim=16)
    (tmp_path / "torn.bin").write_bytes(raw[:len(raw) // 2])
    with pytest.raises(ValueError, match="truncated"):
        thnsw.HnswIndex.load(tmp_path / "torn.bin", dim=16)
    with pytest.raises(ValueError, match="inconsistent"):
        thnsw.HnswIndex.load(jax_file, dim=8)
    (tmp_path / "c.bin").write_bytes(b"RAFTTPU\x00" + raw[8:])
    with pytest.raises(ValueError, match="container"):
        thnsw.HnswIndex.load(tmp_path / "c.bin", dim=16)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean",
                                    "inner_product", "cosine"])
def test_refine_host_equals_jax(metric):
    rng = np.random.default_rng(7)
    data = rng.standard_normal((500, 12)).astype(np.float32)
    q = rng.standard_normal((30, 12)).astype(np.float32)
    cand = rng.integers(-1, 500, (30, 40)).astype(np.int32)
    jv, ji = jrefine.refine_host(data, q, cand, 8, metric)
    tv, ti = trefine.refine_host(data, q, cand, 8, metric)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_array_equal(tv, np.asarray(jv))
    assert tv.dtype == np.float32 and ti.dtype == np.int32


def test_refine_host_validation():
    data = np.zeros((10, 4), np.float32)
    with pytest.raises(ValueError, match="supports"):
        trefine.refine_host(data, data[:2], np.zeros((2, 3), np.int32), 2,
                            "l1")
    with pytest.raises(ValueError, match="out of range"):
        trefine.refine_host(data, data[:2], np.zeros((2, 3), np.int32), 4)
