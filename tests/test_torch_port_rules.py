"""Standing rules of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points run on CUDA unless asked for the CPU (and raise
rather than fall back), and its kernel wrappers take their plain versions
only for CPU tensors, without counting a launch."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from raft_tpu_torch import random as trandom
from raft_tpu_torch import serving
from raft_tpu_torch.bench import io as bench_io
from raft_tpu_torch.bench import runner
from raft_tpu_torch.cluster import kmeans, kmeans_balanced
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.resources import Resources, resolve_device
from raft_tpu_torch.comms import comms as C
from raft_tpu_torch.comms import local_mesh
from raft_tpu_torch.distributed import brute_force as dbf
from raft_tpu_torch.distributed import cagra as dcagra
from raft_tpu_torch.distributed import ivf_bq as dbq
from raft_tpu_torch.distributed import ivf_flat as dflat
from raft_tpu_torch.distributed import ivf_pq as dpq
from raft_tpu_torch.distributed import kmeans as dkm
from raft_tpu_torch import label, spectral
from raft_tpu_torch import sparse as tsparse
from raft_tpu_torch.cluster import single_linkage as tsl
from raft_tpu_torch.neighbors import (ball_cover, batch_knn, brute_force,
                                      cagra, epsilon_neighborhood, hybrid,
                                      ivf_bq, ivf_flat, ivf_pq, nn_descent,
                                      refine)
from raft_tpu_torch.sparse import distance as sp_dist
from raft_tpu_torch.sparse import neighbors as sp_nb
from raft_tpu_torch.ops import _native
from raft_tpu_torch.ops import bq_scan as bq
from raft_tpu_torch.ops import cagra_hop as ch
from raft_tpu_torch.ops import distance as dist
from raft_tpu_torch.ops import pq_scan as ps
from raft_tpu_torch.ops import strip_scan as ss

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _port_files():
    files = sorted((REPO / "raft_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 15
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "raft_tpu"):
                bad.append(f"{f.relative_to(REPO)}: {mod}")
    assert not bad, bad


def test_kernel_sources_are_in_the_package():
    names = [src.name for src in _native.sources()]
    assert names == ["bq_scan.cu", "cagra_hop.cu", "paged_bq_scan.cu",
                     "paged_scan.cu", "pq_scan.cu", "strip_scan.cu"]
    # the strip kernels pick a list-side policy; K5 and K6 stand alone
    policy = {"strip_scan.cu": "dense_src.cuh", "paged_scan.cu": "dense_src.cuh",
              "bq_scan.cu": "packed_src.cuh",
              "paged_bq_scan.cu": "packed_src.cuh"}
    for src in _native.sources():
        assert src.is_file() and src.parent == _native.CSRC
        text = src.read_text()
        if src.name in policy:
            assert f'#include "{policy[src.name]}"' in text
        else:
            assert '#include "' not in text
        assert "raft_tpu/ops/" in text     # names what it replaces
    k6 = (_native.CSRC / "cagra_hop.cu").read_text()
    assert "raft_tpu/ops/cagra_hop.py:_hop_kernel" in k6
    assert 'extern "C" int raft_cagra_hop(' in k6
    assert "int64_t" in k6                  # 64-bit code-record addresses
    k5 = (_native.CSRC / "pq_scan.cu").read_text()
    assert "raft_tpu/ops/pq_scan.py:_pq_scan_kernel" in k5
    assert 'extern "C" int raft_pq_scan(' in k5
    assert "int64_t" in k5                  # 64-bit LUT, code, output offsets
    assert [h.name for h in _native.headers()] == [
        "dense_src.cuh", "packed_src.cuh", "strip_common.cuh"]
    for h in ("dense_src.cuh", "packed_src.cuh"):
        assert '#include "strip_common.cuh"' in (_native.CSRC / h).read_text()
    assert "_build" in (REPO / ".gitignore").read_text()
    # built without fast math or flushed denormals: packed scores near
    # zero are denormals
    flags = " ".join(_native.NVCC_FLAGS)
    assert "fast-math" not in flags and "ftz" not in flags


def test_library_paths_follow_sources_and_the_shared_header(tmp_path,
                                                            monkeypatch):
    """Each source builds its own library, keyed by its own text and the
    shared header's: editing the header rebuilds every kernel."""
    for f in _native.sources() + _native.headers():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_native, "CSRC", tmp_path)
    k1, k2 = tmp_path / "strip_scan.cu", tmp_path / "bq_scan.cu"
    before = {s: _native.library_path(s) for s in (k1, k2)}
    assert before[k1] != before[k2]
    assert before[k1].name.startswith("libstrip_scan-")
    assert before[k2].name.startswith("libbq_scan-")
    assert _native.library_path(k1) == before[k1]      # deterministic
    header = tmp_path / "strip_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for src in (k1, k2):
        assert _native.library_path(src) != before[src]
    edited_k2 = _native.library_path(k2)
    k1.write_text(k1.read_text() + "\n// edited\n")
    assert _native.library_path(k2) == edited_k2        # K1's text only moves K1


def test_build_reports_what_nvcc_refuses(tmp_path, monkeypatch):
    """One nvcc per source, started together; a failure names its source."""
    (tmp_path / "good.cu").write_text("// fine\n")
    (tmp_path / "bad.cu").write_text("// refused\n")
    monkeypatch.setattr(_native, "CSRC", tmp_path)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "_build")
    script = tmp_path / "fake_nvcc"
    script.write_text("#!/bin/sh\n"
                      "for a in \"$@\"; do last=$a; out=$prev; prev=$a; done\n"
                      "case $last in *bad.cu) echo refused; exit 2;; esac\n"
                      "touch \"$out\"\n")
    script.chmod(0o755)
    monkeypatch.setattr(_native, "nvcc", lambda: str(script))
    with pytest.raises(RuntimeError, match="bad.cu: nvcc exit 2"):
        _native.build()
    assert _native.library_path(tmp_path / "good.cu").exists()
    assert not _native.library_path(tmp_path / "bad.cu").exists()


def test_build_keeps_each_kernels_ptxas_report(tmp_path, monkeypatch):
    """The build asks ptxas for its resource report and keeps the log, so
    a run can print every kernel's registers, stack frame and spills."""
    (tmp_path / "k.cu").write_text("// two kernels\n")
    monkeypatch.setattr(_native, "CSRC", tmp_path)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "_build")
    script = tmp_path / "fake_nvcc"
    script.write_text(
        "#!/bin/sh\n"
        "for a in \"$@\"; do out=$prev; prev=$a; done\n"
        "case \" $* \" in *' -Xptxas -v '*) ;; *) exit 3;; esac\n"
        "echo \"ptxas info    : Compiling entry function '_Z1av' for "
        "'sm_90a'\"\n"
        "echo \"ptxas info    : Function properties for _Z1av\"\n"
        "echo \"    40 bytes stack frame, 36 bytes spill stores, 36 bytes "
        "spill loads\"\n"
        "echo \"ptxas info    : Used 80 registers, used 1 barriers, 40 bytes "
        "cumulative stack size\"\n"
        "echo \"ptxas info    : Compiling entry function '_Z1bv' for "
        "'sm_90a'\"\n"
        "echo \"ptxas info    : Used 126 registers, used 1 barriers\"\n"
        "touch \"$out\"\n")
    script.chmod(0o755)
    monkeypatch.setattr(_native, "nvcc", lambda: str(script))
    assert _native.resource_usage(tmp_path / "k.cu") == []    # not built
    _native.build()
    assert _native.resource_usage(tmp_path / "k.cu") == [
        {"kernel": "_Z1av", "registers": 80, "stack_bytes": 40,
         "spill_store_bytes": 36},
        {"kernel": "_Z1bv", "registers": 126, "stack_bytes": 0,
         "spill_store_bytes": 0}]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2048, 8)).astype(np.float32)
    return x, x[:16].copy()


def _entry_points(x, q, **dev):
    idx_cpu = ivf_pq.build(x, ivf_pq.IvfPqParams(
        n_lists=4, pq_dim=4, group_size=512, kmeans_n_iters=2,
        codebook_n_iters=2), device="cpu")
    bq_params = ivf_bq.IvfBqParams(n_lists=4, kmeans_n_iters=2)
    bq_cpu = ivf_bq.build(x, bq_params, device="cpu")
    bf_cpu = brute_force.build(x, device="cpu")
    flat_params = ivf_flat.IvfFlatParams(n_lists=4, kmeans_n_iters=2,
                                         group_size=512)
    flat_cpu = ivf_flat.build(x, flat_params, device="cpu")
    store_cpu = serving.PagedListStore.from_index(flat_cpu, page_rows=64,
                                                  device="cpu")
    cagra_params = cagra.CagraParams(intermediate_graph_degree=16,
                                     graph_degree=8, compress="on")
    cagra_cpu = cagra.build(x[:512], cagra_params, device="cpu")
    half = Bitset.from_mask(np.arange(x.shape[0]) % 2 == 0, device="cpu")
    half512 = Bitset.from_mask(np.arange(512) % 2 == 0, device="cpu")
    nnd_params = nn_descent.NNDescentParams(graph_degree=4,
                                            intermediate_graph_degree=8,
                                            max_iterations=2)
    two = C.Comms(local_mesh(2, device="cpu"))
    pq_params = ivf_pq.IvfPqParams(n_lists=4, pq_dim=4, kmeans_n_iters=2,
                                   codebook_n_iters=2)
    dbf_cpu = dbf.build(x, comms=two, device="cpu")
    dflat_cpu = dflat.build(x, flat_params, comms=two, device="cpu")
    dpq_cpu = dpq.build(x, pq_params, comms=two, device="cpu")
    dbq_cpu = dbq.build(x, bq_params, comms=two, device="cpu")
    dcagra_cpu = dcagra.build(x[:512], cagra_params, comms=two, device="cpu")
    bq_store_cpu = serving.PagedListStore.from_index(bq_cpu, page_rows=64,
                                                     device="cpu")
    sp_rows = (x[:256] > 1.0).astype(np.float32) * x[:256]
    csr_cpu = tsparse.csr_from_dense(sp_rows, device="cpu")
    graph_cpu = sp_nb.knn_graph(x[:256], 6, device="cpu")
    hy_params = ivf_bq.IvfBqParams(n_lists=2, metric="inner_product",
                                   kmeans_n_iters=2)
    hy_cpu = hybrid.build(x[:256], sp_rows, hy_params, sparse_dim=8,
                          device="cpu")
    bc_cpu = ball_cover.build(x[:512], device="cpu")
    return {
        "cagra.build": lambda: cagra.build(x[:512], cagra_params, **dev),
        "cagra.search": lambda: cagra.search(cagra_cpu, q, 5, **dev),
        "CagraIndex.load": lambda: _cagra_file_load(cagra_cpu, **dev),
        "ivf_flat.build": lambda: ivf_flat.build(x, flat_params, **dev),
        "ivf_flat.search": lambda: ivf_flat.search(flat_cpu, q, 5,
                                                   n_probes=2,
                                                   backend="ragged", **dev),
        "ivf_flat.search.gather": lambda: ivf_flat.search(
            flat_cpu, q, 5, n_probes=2, backend="gather", **dev),
        "PagedListStore.from_index": lambda: serving.PagedListStore.from_index(
            flat_cpu, page_rows=64, **dev),
        "serving.search": lambda: serving.search(store_cpu, q, 5, n_probes=2,
                                                 **dev),
        "kmeans_balanced.fit": lambda: kmeans_balanced.fit(
            x, 4, kmeans_balanced.KMeansBalancedParams(n_iters=2), **dev),
        "ivf_pq.build": lambda: ivf_pq.build(x, ivf_pq.IvfPqParams(
            n_lists=4, pq_dim=4, group_size=512, kmeans_n_iters=2,
            codebook_n_iters=2), **dev),
        "ivf_pq.search": lambda: ivf_pq.search(idx_cpu, q, 5, n_probes=2,
                                               backend="ragged", **dev),
        "ivf_pq.search.pallas": lambda: ivf_pq.search(
            idx_cpu, q, 5, n_probes=2, backend="pallas", **dev),
        "ivf_pq.search.gather": lambda: ivf_pq.search(
            idx_cpu, q, 5, n_probes=2, backend="gather", **dev),
        "ivf_pq.build_streaming": lambda: ivf_pq.build_streaming(
            lambda s, e: x[s:e], x.shape[0], x.shape[1], ivf_pq.IvfPqParams(
                n_lists=4, pq_dim=4, kmeans_n_iters=2, codebook_n_iters=2),
            chunk_rows=1024, **dev),
        "ivf_pq.extend": lambda: ivf_pq.extend(idx_cpu, q, **dev),
        "ivf_bq.build": lambda: ivf_bq.build(x, bq_params, **dev),
        "ivf_bq.search": lambda: ivf_bq.search(bq_cpu, q, 5, n_probes=2,
                                               **dev),
        "ivf_bq.search_refined": lambda: ivf_bq.search_refined(
            bq_cpu, x, q, 5, n_probes=2, **dev),
        "refine": lambda: refine.refine(x, q, np.zeros((16, 8), np.int32), 5,
                                        **dev),
        "brute_force.build": lambda: brute_force.build(x, **dev),
        "brute_force.search": lambda: brute_force.search(bf_cpu, q, 5, **dev),
        "brute_force.knn.l1": lambda: brute_force.knn(q, x, 5, "l1", **dev),
        "brute_force.search.filter": lambda: brute_force.search(
            bf_cpu, q, 5, filter=half, **dev),
        "pairwise_distance": lambda: dist.pairwise_distance(
            q, x[:64], "canberra", **dev),
        "ivf_flat.search.filter": lambda: ivf_flat.search(
            flat_cpu, q, 5, n_probes=2, backend="ragged", filter=half, **dev),
        "ivf_flat.extend": lambda: ivf_flat.extend(flat_cpu, q, **dev),
        "serving.search.gather": lambda: serving.search(
            store_cpu, q, 600, n_probes=4, **dev),
        "serving.search.filter": lambda: serving.search(
            store_cpu, q, 5, n_probes=2, filter=half, **dev),
        "serving.search.bq.filter": lambda: serving.search(
            bq_store_cpu, q, 5, n_probes=2, filter=half, **dev),
        "ivf_pq.search.filter": lambda: ivf_pq.search(
            idx_cpu, q, 5, n_probes=2, backend="pallas", filter=half, **dev),
        "ivf_bq.search.filter": lambda: ivf_bq.search_refined(
            bq_cpu, x, q, 5, n_probes=2, filter=half, **dev),
        "ivf_bq.extend": lambda: ivf_bq.extend(bq_cpu, q, **dev),
        "ivf_bq.build_streaming": lambda: ivf_bq.build_streaming(
            lambda s, e: x[s:e], x.shape[0], x.shape[1], bq_params,
            chunk_rows=1024, **dev),
        "cagra.search.filter": lambda: cagra.search(cagra_cpu, q, 5,
                                                    filter=half512, **dev),
        "kmeans.fit": lambda: kmeans.fit(x, kmeans.KMeansParams(
            n_clusters=4, max_iter=3), **dev),
        "kmeans.fit_predict": lambda: kmeans.fit_predict(
            x, kmeans.KMeansParams(n_clusters=4, max_iter=3), **dev),
        "kmeans.predict": lambda: kmeans.predict(x, x[:4], **dev),
        "kmeans.transform": lambda: kmeans.transform(x, x[:4], **dev),
        "kmeans.cluster_cost": lambda: kmeans.cluster_cost(x, x[:4], **dev),
        "nn_descent.build": lambda: nn_descent.build(x[:300], nnd_params,
                                                     **dev),
        "cagra.build.nn_descent": lambda: cagra.build(
            x[:2100], cagra.CagraParams(intermediate_graph_degree=8,
                                        graph_degree=4,
                                        build_algo="nn_descent",
                                        nn_descent_niter=2), **dev),
        "comms.local_mesh": lambda: local_mesh(2, device=_device_of(dev)),
        "comms.make_comms": lambda: C.make_comms(dev.get("res")
                                                 or _res_of(dev)),
        "distributed.brute_force.build": lambda: dbf.build(x, comms=two,
                                                           **dev),
        "distributed.brute_force.search": lambda: dbf.search(
            dbf_cpu, q, 5, filter=half, **dev),
        "distributed.kmeans.fit": lambda: dkm.fit(x, kmeans.KMeansParams(
            n_clusters=4, max_iter=3), comms=two, **dev),
        "distributed.kmeans.fit_balanced": lambda: dkm.fit_balanced(
            x, 4, kmeans_balanced.KMeansBalancedParams(n_iters=2), comms=two,
            **dev),
        "distributed.ivf_flat.build": lambda: dflat.build(x, flat_params,
                                                          comms=two, **dev),
        "distributed.ivf_flat.search": lambda: dflat.search(
            dflat_cpu, q, 5, n_probes=2, **dev),
        "distributed.ivf_pq.build": lambda: dpq.build(x, pq_params, comms=two,
                                                      **dev),
        "distributed.ivf_pq.search": lambda: dpq.search(dpq_cpu, q, 5,
                                                        n_probes=2, **dev),
        "distributed.ivf_bq.build": lambda: dbq.build(x, bq_params, comms=two,
                                                      **dev),
        "distributed.ivf_bq.search": lambda: dbq.search(dbq_cpu, q, 5,
                                                        n_probes=2, **dev),
        "distributed.cagra.build": lambda: dcagra.build(
            x[:512], cagra_params, comms=two, **dev),
        "distributed.cagra.search": lambda: dcagra.search(dcagra_cpu, q, 5,
                                                          **dev),
        "random.make_blobs": lambda: trandom.make_blobs(0, 64, 4, **dev),
        "random.rmat": lambda: trandom.rmat(0, 3, 2, 16, **dev),
        "bench.io.generate_groundtruth": lambda: bench_io.generate_groundtruth(
            x[:256], q, k=3, **dev),
        "bench.runner.run_benchmark": lambda: runner.run_benchmark(
            {"dataset": {"kind": "blobs", "n": 256, "dim": 4,
                         "n_queries": 8, "n_clusters": 4},
             "k": 3, "algos": [{"name": "brute_force"}]}, reps=1, **dev),
        "sparse.coo_from_dense": lambda: tsparse.coo_from_dense(
            sp_rows, device=_device_of(dev)).rows,
        "sparse.pairwise_distance": lambda: sp_dist.pairwise_distance(
            csr_cpu, csr_cpu, "l1", **dev),
        "sparse.brute_force_knn": lambda: sp_nb.brute_force_knn(
            csr_cpu, csr_cpu, 3, **dev),
        "sparse.knn_graph": lambda: sp_nb.knn_graph(x[:256], 6, **dev).vals,
        "sparse.lanczos_smallest": lambda: tsparse.lanczos_smallest(
            lambda v: 2.0 * v, 2, n=16, device=_device_of(dev)),
        "label.make_monotonic": lambda: label.make_monotonic(
            np.array([3, 1, 3]), device=_device_of(dev)),
        "single_linkage": lambda: tsl.single_linkage(x[:256], 4,
                                                     **dev).labels,
        "spectral.partition": lambda: spectral.partition(graph_cpu, 2,
                                                         **dev),
        "hybrid.build": lambda: hybrid.build(
            x[:256], sp_rows, hy_params, sparse_dim=8, **dev).index.centers,
        "hybrid.project_sparse": lambda: hybrid.project_sparse(
            sp_rows, 8, device=_device_of(dev)),
        "hybrid.search": lambda: hybrid.search(hy_cpu, q, sp_rows[:16], 5,
                                               n_probes=2, **dev),
        "hybrid.to_store": lambda: serving.search(
            hybrid.to_store(hy_cpu, page_rows=64, **dev),
            hybrid.fuse_queries(hy_cpu, q, sp_rows[:16]), 5, n_probes=2,
            **dev),
        "batch_knn.search_device_chunked": lambda:
            batch_knn.search_device_chunked(x, q, 5, chunk_rows=500, **dev),
        "batch_knn.search_out_of_core": lambda: batch_knn.search_out_of_core(
            x, q, 5, chunk_rows=500, **dev),
        "batch_knn.BatchKQuery": lambda: next(iter(batch_knn.BatchKQuery(
            bf_cpu, q, 4, **dev))),
        "ball_cover.build": lambda: ball_cover.build(x[:512],
                                                     **dev).landmarks,
        "ball_cover.knn_query": lambda: ball_cover.knn_query(bc_cpu, q, 3,
                                                             **dev),
        "ball_cover.eps_nn": lambda: ball_cover.eps_nn(bc_cpu, q, 1.0, **dev),
        "epsilon_neighborhood.eps_neighbors": lambda:
            epsilon_neighborhood.eps_neighbors(q, x[:64], 1.0, **dev),
    }


def _device_of(dev):
    """The device a test's entry-point kwargs ask for (None: the default)."""
    if "device" in dev:
        return dev["device"]
    return dev["res"].device if "res" in dev else None


def _res_of(dev):
    return Resources(device=_device_of(dev) or "cuda")


def _cagra_file_load(index, **dev):
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "cagra.bin"
        index.save(path)
        return cagra.CagraIndex.load(path, **dev).graph


@pytest.mark.parametrize("name", ["cagra.build", "cagra.search",
                                  "CagraIndex.load",
                                  "ivf_flat.build", "ivf_flat.search",
                                  "ivf_flat.search.gather",
                                  "PagedListStore.from_index",
                                  "serving.search",
                                  "kmeans_balanced.fit", "ivf_pq.build",
                                  "ivf_pq.search", "ivf_pq.search.pallas",
                                  "ivf_pq.search.gather",
                                  "ivf_pq.build_streaming", "ivf_pq.extend",
                                  "ivf_bq.build",
                                  "ivf_bq.search", "ivf_bq.search_refined",
                                  "refine", "brute_force.build",
                                  "brute_force.search", "brute_force.knn.l1",
                                  "brute_force.search.filter",
                                  "pairwise_distance",
                                  "ivf_flat.search.filter", "ivf_flat.extend",
                                  "serving.search.gather",
                                  "serving.search.filter",
                                  "serving.search.bq.filter",
                                  "ivf_pq.search.filter",
                                  "ivf_bq.search.filter", "ivf_bq.extend",
                                  "ivf_bq.build_streaming",
                                  "cagra.search.filter", "kmeans.fit",
                                  "kmeans.fit_predict", "kmeans.predict",
                                  "kmeans.transform", "kmeans.cluster_cost",
                                  "nn_descent.build",
                                  "cagra.build.nn_descent",
                                  "comms.local_mesh", "comms.make_comms",
                                  "distributed.brute_force.build",
                                  "distributed.brute_force.search",
                                  "distributed.kmeans.fit",
                                  "distributed.kmeans.fit_balanced",
                                  "distributed.ivf_flat.build",
                                  "distributed.ivf_flat.search",
                                  "distributed.ivf_pq.build",
                                  "distributed.ivf_pq.search",
                                  "distributed.ivf_bq.build",
                                  "distributed.ivf_bq.search",
                                  "distributed.cagra.build",
                                  "distributed.cagra.search",
                                  "random.make_blobs", "random.rmat",
                                  "bench.io.generate_groundtruth",
                                  "bench.runner.run_benchmark",
                                  "sparse.coo_from_dense",
                                  "sparse.pairwise_distance",
                                  "sparse.brute_force_knn",
                                  "sparse.knn_graph",
                                  "sparse.lanczos_smallest",
                                  "label.make_monotonic", "single_linkage",
                                  "spectral.partition", "hybrid.build",
                                  "hybrid.project_sparse", "hybrid.search",
                                  "hybrid.to_store",
                                  "batch_knn.search_device_chunked",
                                  "batch_knn.search_out_of_core",
                                  "batch_knn.BatchKQuery",
                                  "ball_cover.build", "ball_cover.knn_query",
                                  "ball_cover.eps_nn",
                                  "epsilon_neighborhood.eps_neighbors"])
def test_entry_points_raise_without_cuda(no_cuda, small, name):
    x, q = small
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points(x, q)[name]()


@pytest.mark.parametrize("how", ["device", "resources"])
def test_entry_points_run_on_cpu_when_asked(no_cuda, small, how):
    x, q = small
    dev = ({"device": "cpu"} if how == "device"
           else {"res": Resources(device="cpu")})
    for name, fn in _entry_points(x, q, **dev).items():
        out = fn()
        tensors = out if isinstance(out, tuple) else (out,)
        for t in tensors:
            if isinstance(t, torch.Tensor):
                assert t.device.type == "cpu", name


def test_resolve_device_default_is_cuda(no_cuda):
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


def _generator_operand_calls(dev):
    """The generators that take the caller's tensors, with operands on
    ``dev`` and their results asked for there."""
    a = torch.tensor([[2.0, 0.5], [0.5, 1.0]], dtype=torch.float64)
    return {
        "make_blobs.centers": lambda: trandom.make_blobs(
            0, 32, 2, centers=torch.zeros(3, 2).to(dev), device=dev),
        "multi_variable_gaussian": lambda: trandom.multi_variable_gaussian(
            0, torch.zeros(2).to(dev), a.to(dev), 16, device=dev),
        "rmat.theta": lambda: trandom.rmat(
            0, 3, 2, 16, theta=torch.full((3, 4), 0.25).to(dev),
            device=dev),
    }


@pytest.mark.parametrize("name", sorted(_generator_operand_calls("cpu")))
def test_generators_compute_on_their_operands_device(name):
    """A generator handed tensors off the host computes on their device and
    never fetches them to the host. The meta device stands in for the card
    here: a meta tensor cannot be copied to the host, so a host fetch of an
    operand raises."""
    out = _generator_operand_calls("meta")[name]()
    for t in out if isinstance(out, tuple) else (out,):
        assert t.device.type == "meta", name


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_generator_operand_calls("cpu")))
def test_generators_keep_card_operands_on_the_card(name):
    """The same calls with operands on the card: results on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = _generator_operand_calls("cuda")[name]()
    for t in out if isinstance(out, tuple) else (out,):
        assert t.device.type == "cuda", name


def test_bitsets_from_host_data_default_to_cuda(no_cuda):
    """A bitset made from host data lives on the card unless the caller
    asks for the CPU; one made from a tensor keeps the tensor's device."""
    mask = np.arange(40) % 3 == 0
    for make in (lambda **d: Bitset.from_mask(mask, **d),
                 lambda **d: Bitset.create(40, **d),
                 lambda **d: Bitset.from_numpy_words(np.zeros(2, np.uint32),
                                                     40, **d)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        assert make(device="cpu").device.type == "cpu"
    assert Bitset.from_mask(torch.from_numpy(mask)).device.type == "cpu"


# the modules this slice added or extended on a kernel path: a CUDA tensor
# gets the kernel or an exception, never a quiet detour
FILTER_SLICE_MODULES = (
    "raft_tpu_torch/core/bitset.py", "raft_tpu_torch/neighbors/_filtering.py",
    "raft_tpu_torch/neighbors/ivf_flat.py",
    "raft_tpu_torch/neighbors/ivf_bq.py",
    "raft_tpu_torch/neighbors/brute_force.py",
    "raft_tpu_torch/ops/distance.py", "raft_tpu_torch/serving/store.py",
    "raft_tpu_torch/serving/__init__.py")


@pytest.mark.parametrize("rel", FILTER_SLICE_MODULES)
def test_no_try_on_the_filter_and_remainder_paths(rel):
    tree = ast.parse((REPO / rel).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], rel


def test_paged_auto_never_picks_a_twin_by_name():
    """``"auto"`` resolves to K3/K4 ("paged") or, for flat and PQ stores,
    the gather scan; K4's plain twin ("paged_jnp") runs only when named."""
    src = (REPO / "raft_tpu_torch/neighbors/ivf_flat.py").read_text()
    body = src[src.index("def paged_backend_auto"):
               src.index("def check_paged_eligible")]
    assert "paged_jnp" not in body
    assert 'return "paged"' in body and 'return "gather"' in body


def test_k1_wrapper_takes_plain_path_on_cpu_without_counting():
    rng = np.random.default_rng(1)
    sl = torch.tensor([0, -1, 1], dtype=torch.int32)
    a = torch.from_numpy(rng.standard_normal((3, ss.C, 8)).astype(np.float32)
                         ).to(torch.bfloat16)
    b = torch.from_numpy(rng.integers(-127, 128, (2, 512, 8)).astype(np.int8))
    bias = torch.from_numpy(rng.random((2, 512)).astype(np.float32))
    before = ss.STRIP_KERNEL.launches
    got = ss.strip_class(sl, a, b, bias, 1, 1, -2.0, 10)
    want = ss._strip_class_plain(sl, a, b, bias, 1, 1, -2.0, 10)
    assert ss.STRIP_KERNEL.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g[sl >= 0], w[sl >= 0])


def test_k1_wrapper_rejects_what_the_kernel_cannot_take():
    sl = torch.zeros(1, dtype=torch.int32)
    a = torch.zeros((1, ss.C, 8), dtype=torch.bfloat16)
    b = torch.zeros((1, 512, 8), dtype=torch.int8)
    bias = torch.zeros((1, 512))
    with pytest.raises(ValueError, match="kf"):
        ss.strip_class(sl, a, b, bias, 1, 1, -2.0, ss.MAX_KF + 1)
    with pytest.raises(ValueError, match="spans"):
        ss.strip_class(sl, a, b, bias, 1, 2, -2.0, 10)


def _k2_operands(rng, nb=16):
    sl = torch.tensor([0, -1, 1], dtype=torch.int32)
    a = torch.from_numpy(rng.standard_normal((3, ss.C, 8 * nb)).astype(
        np.float32)).to(torch.bfloat16)
    codes = torch.from_numpy(rng.integers(0, 256, (2, 512, nb)).astype(np.uint8))
    scale = torch.from_numpy(rng.uniform(0.5, 2, (2, 512)).astype(np.float32))
    bias = torch.from_numpy(rng.random((2, 512)).astype(np.float32))
    return sl, a, codes, scale, bias


def test_k2_wrapper_takes_plain_path_on_cpu_without_counting():
    sl, a, codes, scale, bias = _k2_operands(np.random.default_rng(2))
    before = (bq.BQ_KERNEL.launches, ss.STRIP_KERNEL.launches)
    got = bq.bq_class(sl, a, codes, scale, bias, 1, 1, -2.0, 40)
    want = bq._bq_class_plain(sl, a, codes, scale, bias, 1, 1, -2.0, 40)
    assert (bq.BQ_KERNEL.launches, ss.STRIP_KERNEL.launches) == before
    for g, w in zip(got, want):
        assert torch.equal(g[sl >= 0], w[sl >= 0])


def test_k2_wrapper_rejects_what_the_kernel_cannot_take():
    sl, a, codes, scale, bias = _k2_operands(np.random.default_rng(3))
    with pytest.raises(ValueError, match="kf"):
        bq.bq_class(sl, a, codes, scale, bias, 1, 1, -2.0, ss.MAX_KF + 1)
    with pytest.raises(ValueError, match="spans"):
        bq.bq_class(sl, a, codes, scale, bias, 1, 2, -2.0, 10)
    with pytest.raises(ValueError, match="dim mismatch"):
        bq.bq_class(sl, a[:, :, :64], codes, scale, bias, 1, 1, -2.0, 10)
    with pytest.raises(ValueError, match="scale"):
        bq.bq_class(sl, a, codes, scale[:, :256], bias, 1, 1, -2.0, 10)
    # the checks a CUDA call makes before it launches (run here on CPU
    # tensors: they reject before any card is touched)
    with pytest.raises(TypeError, match="bf16"):
        ss.check_cuda_operands(a.float(), sl, None, list_codes=codes,
                               scale=scale, bias=bias)
    with pytest.raises(TypeError, match="scale must be fp32"):
        ss.check_cuda_operands(a, sl, None, list_codes=codes,
                               scale=scale.double(), bias=bias)
    with pytest.raises(ValueError, match="contiguous"):
        ss.check_cuda_operands(a, sl, None, list_codes=codes[:, ::2],
                               scale=scale, bias=bias)
    with pytest.raises(ValueError, match="strip_rows"):
        ss.check_cuda_operands(a, sl, sl.long(), list_codes=codes,
                               scale=scale, bias=bias)


def _paged_operands(rng, nb=None, dtype=np.uint8):
    """A two-list paged class: 2 pages of 64 rows per list, one strip per
    list and a padding strip."""
    sl = torch.tensor([0, -1, 1], dtype=torch.int32)
    width = 8 * nb if nb else 16
    a = torch.from_numpy(rng.standard_normal((3, ss.C, width)).astype(
        np.float32)).to(torch.bfloat16)
    last = nb if nb else 16
    pages = torch.from_numpy(rng.integers(0, 128, (5, 64, last)).astype(dtype))
    bias = torch.from_numpy(rng.random((5, 64)).astype(np.float32))
    table = torch.tensor([3, 1, 0, 4], dtype=torch.int32)
    chain = torch.tensor([2, 1], dtype=torch.int32)
    sub_live = torch.ones(2, dtype=torch.int32)
    return sl, table, chain, sub_live, a, pages, bias


def test_k3_wrapper_takes_plain_path_on_cpu_without_counting():
    sl, table, chain, live, a, pages, bias = _paged_operands(
        np.random.default_rng(4))
    before = (ss.PAGED_KERNEL.launches, ss.STRIP_KERNEL.launches)
    got = ss.paged_class(sl, table, chain, live, a, pages, bias, 2, 1, 64, 2,
                         -2.0, 20)
    want = ss._paged_class_plain(sl, table, chain, live, a, pages, bias, 2, 1,
                                 64, 2, -2.0, 20)
    assert (ss.PAGED_KERNEL.launches, ss.STRIP_KERNEL.launches) == before
    for g, w in zip(got, want):
        assert torch.equal(g[sl >= 0], w[sl >= 0])


def test_k3_wrapper_rejects_what_the_kernel_cannot_take():
    sl, table, chain, live, a, pages, bias = _paged_operands(
        np.random.default_rng(5))
    args = (sl, table, chain, live, a, pages, bias)
    with pytest.raises(ValueError, match="kf"):
        ss.paged_class(*args, 2, 1, 64, 2, -2.0, 129)
    with pytest.raises(ValueError, match="pages hold 64 rows"):
        ss.paged_class(*args, 4, 1, 32, 2, -2.0, 10)
    with pytest.raises(ValueError, match="sub_live"):
        ss.paged_class(*args, 1, 2, 64, 2, -2.0, 10)
    with pytest.raises(ValueError, match="chain_pages"):
        ss.paged_class(sl, table, chain[:1], live, a, pages, bias, 2, 1, 64, 2,
                       -2.0, 10)
    with pytest.raises(ValueError, match="dim mismatch"):
        ss.paged_class(sl, table, chain, live, a[:, :, :8], pages, bias, 2, 1,
                       64, 2, -2.0, 10)
    with pytest.raises(TypeError, match="table_flat must be int32"):
        ss.check_paged_operands(table.long(), chain, live)
    with pytest.raises(ValueError, match="contiguous"):
        ss.check_paged_operands(table, chain, torch.ones(4, dtype=torch.int32)[::2])


def test_k4_wrapper_takes_plain_path_on_cpu_without_counting():
    rng = np.random.default_rng(6)
    sl, table, chain, live, a, codes, bias = _paged_operands(rng, nb=16)
    scale = torch.from_numpy(rng.uniform(0.5, 2, (5, 64)).astype(np.float32))
    before = (bq.PAGED_BQ_KERNEL.launches, bq.BQ_KERNEL.launches)
    got = bq.paged_bq_class(sl, table, chain, live, a, codes, scale, bias, 2,
                            1, 64, 2, -2.0, 40)
    want = bq._paged_bq_class_plain(sl, table, chain, live, a, codes, scale,
                                    bias, 2, 1, 64, 2, -2.0, 40)
    assert (bq.PAGED_BQ_KERNEL.launches, bq.BQ_KERNEL.launches) == before
    for g, w in zip(got, want):
        assert torch.equal(g[sl >= 0], w[sl >= 0])


def test_k4_wrapper_rejects_what_the_kernel_cannot_take():
    rng = np.random.default_rng(7)
    sl, table, chain, live, a, codes, bias = _paged_operands(rng, nb=16)
    scale = torch.ones((5, 64))
    with pytest.raises(ValueError, match="scale_pool"):
        bq.paged_bq_class(sl, table, chain, live, a, codes, scale[:, :32],
                          bias, 2, 1, 64, 2, -2.0, 10)
    with pytest.raises(ValueError, match="dim mismatch"):
        bq.paged_bq_class(sl, table, chain, live, a[:, :, :64], codes, scale,
                          bias, 2, 1, 64, 2, -2.0, 10)
    with pytest.raises(ValueError, match="kf"):
        bq.paged_bq_class(sl, table, chain, live, a, codes, scale, bias, 2, 1,
                          64, 2, -2.0, 200)


def test_k6_wrapper_takes_plain_path_on_cpu_without_counting():
    rng = np.random.default_rng(8)
    n, deg, p, q, w, itopk = 64, 4, 8, 6, 2, 8
    args = [torch.from_numpy(a) for a in (
        rng.integers(0, n, (q, itopk)).astype(np.int32),
        np.sort(rng.random((q, itopk)).astype(np.float32), axis=1) + 1,
        np.zeros((q, itopk), np.float32),
        rng.integers(-1, n, (q, w)).astype(np.int32),
        rng.integers(-5, 6, (q, p)).astype(np.float32),
        rng.integers(-1, n, (n, deg)).astype(np.int32),
        rng.integers(-127, 128, (n, deg, p)).astype(np.int8))]
    before = (ch.HOP_KERNEL.launches, ss.STRIP_KERNEL.launches)
    got = ch.fused_hop(*args)
    want = ch.fused_hop_reference(*args)
    assert (ch.HOP_KERNEL.launches, ss.STRIP_KERNEL.launches) == before
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


def test_no_path_leads_from_k6_to_a_fallback():
    """A CUDA tensor gets K6 or an exception: the hop's module and the
    CAGRA search hold no try/except (the JAX package reruns a failed fused
    tile on the unfused loop; the port does not), and the wrapper raises
    when the launch returns an error."""
    for rel in ("raft_tpu_torch/ops/cagra_hop.py",
                "raft_tpu_torch/neighbors/cagra.py"):
        tree = ast.parse((REPO / rel).read_text())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], rel
    src = (REPO / "raft_tpu_torch/ops/cagra_hop.py").read_text()
    body = src[src.index("def _fused_hop_cuda"):src.index("def fused_hop(")]
    assert "_kernel_fn()(" in body and "raise RuntimeError" in body
    assert body.index("raise RuntimeError") < body.index(
        "HOP_KERNEL.launches += 1")


def test_k5_wrapper_takes_plain_path_on_cpu_without_counting():
    rng = np.random.default_rng(6)
    args = (torch.from_numpy(rng.integers(-64, 65, (4, 16, 8 * 16)).astype(
        np.float32)).to(torch.bfloat16),
        torch.from_numpy(rng.integers(0, 16, (4, 8, 128)).astype(np.uint8)),
        torch.from_numpy(rng.random((4, 128)).astype(np.float32)), 16)
    before = ps.PQ_KERNEL.launches
    assert torch.equal(ps.pq_scan(*args), ps.pq_scan_reference(*args))
    assert ps.PQ_KERNEL.launches == before


def test_k5_wrapper_rejects_what_the_kernel_cannot_take():
    luts = torch.zeros((2, 16, 8 * 16), dtype=torch.bfloat16)
    codes = torch.zeros((2, 8, 128), dtype=torch.uint8)
    b_sum = torch.zeros((2, 128))
    with pytest.raises(ValueError, match="power of two"):
        ps.pq_scan(luts, codes, b_sum, 12)
    with pytest.raises(ValueError, match="power of two"):
        ps.pq_scan(torch.zeros((2, 16, 8 * 512), dtype=torch.bfloat16),
                    codes, b_sum, 512)
    with pytest.raises(ValueError, match="inconsistent"):
        ps.pq_scan(luts, codes, b_sum, 32)
    with pytest.raises(ValueError, match="inconsistent"):
        ps.pq_scan(luts, codes, b_sum[:, :64], 16)
    with pytest.raises(TypeError, match="luts_grouped"):
        ps.pq_scan(luts.float(), codes, b_sum, 16)
    with pytest.raises(TypeError, match="codes_t"):
        ps.pq_scan(luts, codes.to(torch.int8), b_sum, 16)
    with pytest.raises(TypeError, match="b_sum"):
        ps.pq_scan(luts, codes, b_sum.double(), 16)


def test_no_path_leads_from_k5_to_a_fallback():
    """A CUDA tensor gets K5 or an exception: the scan's module and the
    IVF-PQ search hold no try/except, and the wrapper raises when the
    launch returns an error, before it counts a launch."""
    for rel in ("raft_tpu_torch/ops/pq_scan.py",
                "raft_tpu_torch/neighbors/ivf_pq.py"):
        tree = ast.parse((REPO / rel).read_text())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], rel
    src = (REPO / "raft_tpu_torch/ops/pq_scan.py").read_text()
    body = src[src.index("def _pq_scan_cuda"):src.index("def pq_scan(")]
    assert "_kernel_fn()(" in body and "raise RuntimeError" in body
    assert body.index("raise RuntimeError") < body.index(
        "PQ_KERNEL.launches += 1")
    wrapper = src[src.index("def pq_scan("):]
    assert 'device.type == "cuda"' in wrapper


# ---------------------------------------------------------------------------
# the resilience and observability core
# ---------------------------------------------------------------------------

CORE_MODULES = (
    "core/interruptible.py", "core/logger.py", "core/fsio.py",
    "core/trace.py", "obs/__init__.py", "obs/tracing.py", "obs/aggregate.py",
    "obs/registry.py", "obs/health.py", "resilience/__init__.py",
    "resilience/errors.py", "resilience/retry.py",
    "resilience/faultinject.py", "resilience/deadline.py",
    "resilience/shard_health.py", "utils/tiling.py", "cluster/kmeans.py")


@pytest.mark.parametrize("rel", CORE_MODULES)
def test_core_modules_import_neither_jax_nor_the_jax_package(rel):
    path = REPO / "raft_tpu_torch" / rel
    assert path in _port_files()
    roots = {m.split(".")[0] for m in _imported_modules(path)}
    assert not roots & {"jax", "jaxlib", "raft_tpu"}, rel


# the obs cost layer and the serving managers (Queue 1 items 2 and 3)
COST_SERVING_MODULES = (
    "obs/compile.py", "obs/memory.py", "obs/costmodel.py", "obs/roofline.py",
    "obs/shadow.py", "serving/batching.py", "serving/compaction.py",
    "serving/maintenance.py", "serving/capacity.py")


@pytest.mark.parametrize("rel", COST_SERVING_MODULES)
def test_cost_and_serving_modules_import_neither_jax_nor_the_jax_package(rel):
    path = REPO / "raft_tpu_torch" / rel
    assert path in _port_files()
    roots = {m.split(".")[0] for m in _imported_modules(path)}
    assert not roots & {"jax", "jaxlib", "raft_tpu"}, rel


#: the JAX managers' try statements (AST nodes), each classifying a
#: failure and recording it; the port keeps exactly these and adds none
_MANAGER_TRIES = {"serving/batching.py": 3, "serving/compaction.py": 3,
                  "serving/maintenance.py": 3, "serving/capacity.py": 9}


@pytest.mark.parametrize("rel", sorted(_MANAGER_TRIES))
def test_managers_keep_the_jax_try_blocks_and_add_none(rel):
    trees = [ast.parse((REPO / pkg / rel).read_text())
             for pkg in ("raft_tpu", "raft_tpu_torch")]
    counts = [sum(isinstance(n, ast.Try) for n in ast.walk(t))
              for t in trees]
    assert counts == [_MANAGER_TRIES[rel]] * 2, (rel, counts)


_RECOVERY = ("degrade_on_oom", "with_retries")
_LOADERS = ("build", "load", "CDLL", "_kernel_fn", "nvcc")


def _recovered_bodies(tree):
    """The functions and lambdas passed to a recovery executor, found by
    name in the same module."""
    defs = {n.name: n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    for call in ast.walk(tree):
        if not isinstance(call, ast.Call) or not call.args:
            continue
        fn = call.func
        name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
            fn, "id", "")
        if name not in _RECOVERY:
            continue
        arg = call.args[0]
        if isinstance(arg, ast.Lambda):
            yield arg
        elif isinstance(arg, ast.Name) and arg.id in defs:
            yield defs[arg.id]


def test_no_recovery_executor_encloses_a_kernel_build_or_load():
    """Every function handed to degrade_on_oom or with_retries in the port
    neither builds nor loads a kernel library itself, and ``_native``
    reaches for no recovery executor."""
    found = 0
    for path in (REPO / "raft_tpu_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for body in _recovered_bodies(tree):
            found += 1
            for node in ast.walk(body):
                if isinstance(node, ast.Attribute) and isinstance(
                        node.value, ast.Name) and node.value.id in (
                            "_native", "ctypes"):
                    assert node.attr not in _LOADERS, (path, node.attr)
                if isinstance(node, ast.Name):
                    assert node.id not in ("_kernel_fn", "CDLL"), path
    assert found >= 5
    roots = set(_imported_modules(REPO / "raft_tpu_torch/ops/_native.py"))
    assert not any("resilience" in m for m in roots)


def test_a_failed_nvcc_classifies_fatal(tmp_path, monkeypatch):
    """Whatever nvcc prints — here words of the transient and OOM tables —
    its failure is a NativeBuildError, FATAL, and no recovery executor runs
    it twice."""
    from raft_tpu_torch import resilience

    (tmp_path / "k.cu").write_text("// refused\n")
    monkeypatch.setattr(_native, "CSRC", tmp_path)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "_build")
    script = tmp_path / "fake_nvcc"
    script.write_text("#!/bin/sh\necho 'resource temporarily unavailable; "
                      "connection reset; out of memory'\nexit 1\n")
    script.chmod(0o755)
    monkeypatch.setattr(_native, "nvcc", lambda: str(script))
    with pytest.raises(_native.NativeBuildError) as ei:
        _native.build()
    assert resilience.classify(ei.value) == resilience.FATAL
    calls = []

    def attempt(size):
        calls.append(size)
        return _native.build()

    with pytest.raises(_native.NativeBuildError):
        resilience.degrade_on_oom(attempt, 64, floor=1)
    with pytest.raises(_native.NativeBuildError):
        resilience.with_retries(lambda: attempt(0), sleep=lambda s: None)
    assert calls == [64, 0]
    lib = _native.library_path(tmp_path / "k.cu")
    lib.parent.mkdir(parents=True, exist_ok=True)
    lib.write_bytes(b"not a library")
    monkeypatch.setattr(_native, "_loaded", {})
    with pytest.raises(_native.NativeBuildError) as ei:
        _native.load("k")
    assert resilience.classify(ei.value) == resilience.FATAL
    with pytest.raises(_native.NativeBuildError):
        _native.load("missing")


def test_missing_nvcc_classifies_fatal(monkeypatch):
    from torch.utils import cpp_extension

    from raft_tpu_torch import resilience

    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    with pytest.raises(_native.NativeBuildError) as ei:
        _native.nvcc()
    assert resilience.classify(ei.value) == resilience.FATAL


def test_telemetry_initialises_no_cuda_context():
    """Importing obs and recording spans (telemetry off, then on in sync
    mode), sampling memory, reading the memory budget and the platform
    peaks never initialise CUDA: the child makes CUDA's lazy init raise."""
    import subprocess
    import sys

    code = (
        "import torch\n"
        "def boom(*a, **k):\n"
        "    raise AssertionError('CUDA initialised')\n"
        "torch.cuda._lazy_init = boom\n"
        "from raft_tpu_torch import obs\n"
        "from raft_tpu_torch.core.trace import traced\n"
        "with obs.record_span('off'):\n"
        "    pass\n"
        "traced('t')(lambda: None)()\n"
        "obs.enable(); obs.enable_sync()\n"
        "with obs.record_span('on'):\n"
        "    with obs.record_span('inner'):\n"
        "        pass\n"
        "traced('t')(lambda: None)()\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert len(obs.spans()) == 3\n"
        "from raft_tpu_torch.obs import costmodel, memory, roofline\n"
        "assert memory.sample('t')['source'] == 'live_arrays'\n"
        "assert costmodel.hbm_budget()['source'] == 'unknown'\n"
        "assert roofline.platform_peaks()['source'] == 'unknown'\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# the CAGRA remainder, comms and the distributed indexes: K1 and K2 run on
# their shard scans, so a CUDA shard gets the kernel or an exception
REMAINDER_COMMS_MODULES = (
    "neighbors/nn_descent.py", "neighbors/hnsw.py", "neighbors/refine.py",
    "native/__init__.py", "ops/segment.py", "comms/comms.py",
    "comms/self_test.py", "distributed/brute_force.py",
    "distributed/kmeans.py", "distributed/ivf_flat.py",
    "distributed/ivf_pq.py", "distributed/ivf_bq.py", "distributed/cagra.py",
    "distributed/snapshot.py")


@pytest.mark.parametrize("rel", REMAINDER_COMMS_MODULES)
def test_no_try_on_the_remainder_and_distributed_paths(rel):
    path = REPO / "raft_tpu_torch" / rel
    assert path in _port_files()
    tree = ast.parse(path.read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], rel


#: the JAX modules' try statements: the shard probe's classification of a
#: failing shard, and the bootstrap's bounded coordinator probe
_GATE_TRIES = {"distributed/_sharding.py": ("probe_shards",),
               "comms/bootstrap.py": ("_probe_coordinator",)}


@pytest.mark.parametrize("rel", sorted(_GATE_TRIES))
def test_gates_keep_the_jax_try_blocks_and_add_none(rel):
    """The port's try statements sit in the JAX package's gate functions
    only, no more of them than there, and none on the shard scans."""
    trees = [ast.parse((REPO / pkg / rel).read_text())
             for pkg in ("raft_tpu", "raft_tpu_torch")]
    counts = [sum(isinstance(n, ast.Try) for n in ast.walk(t))
              for t in trees]
    assert 1 <= counts[1] <= counts[0], (rel, counts)
    for fn in ast.walk(trees[1]):
        if isinstance(fn, ast.FunctionDef) and any(
                isinstance(n, ast.Try) for n in ast.walk(fn)):
            assert fn.name in _GATE_TRIES[rel], (rel, fn.name)


def test_shard_scans_follow_the_device_rule():
    """A CUDA shard runs the strip engine (K1 / K2) wherever the lists
    allow it, a CPU shard the dense scan: the engine is picked from the
    shards' devices, never from a failure."""
    from raft_tpu_torch.distributed import _sharding as sh

    cpu = C.Comms(local_mesh(2, device="cpu"))
    assert sh.search_engine_dense(cpu, 512) is True
    assert sh.search_engine_dense(cpu, 3 * ss.MC) is True
    # a mesh of CUDA shards is only described here, never launched on
    cuda0 = torch.device("cuda", 0)
    on_card = C.Comms(C.Mesh(np.array([cuda0, cuda0], dtype=object),
                             ("data",)))
    assert sh.search_engine_dense(on_card, 4 * ss.MC) is False
    assert sh.search_engine_dense(on_card, 3 * ss.MC) is True
    # one CPU shard must not turn a CUDA shard's scan into the twin
    with pytest.raises(ValueError, match="one device type"):
        C.Mesh(np.array([cuda0, torch.device("cpu")], dtype=object),
               ("data",))


# the obs remainder, the tuning loop and the bench runner entry point
OBS_TUNING_RUNNER_MODULES = (
    "obs/slo.py", "obs/report.py", "obs/explain.py", "obs/flight.py",
    "obs/aggregate.py", "obs/tracing.py", "bench/progress.py",
    "bench/datasets.py", "bench/io.py", "bench/runner.py",
    "bench/__init__.py", "tuning/__init__.py", "tuning/autotune.py",
    "serving/controller.py", "random/__init__.py", "random/generators.py")


@pytest.mark.parametrize("rel", OBS_TUNING_RUNNER_MODULES)
def test_slice_modules_sit_at_the_jax_paths_and_import_no_jax(rel):
    path = REPO / "raft_tpu_torch" / rel
    assert path in _port_files() and (REPO / "raft_tpu" / rel).is_file()
    roots = {m.split(".")[0] for m in _imported_modules(path)}
    assert not roots & {"jax", "jaxlib", "raft_tpu"}, rel


@pytest.mark.parametrize("rel", ["bench/progress.py", "obs/aggregate.py"])
def test_stdlib_modules_import_no_torch_at_module_level(rel):
    """Module-level imports only (function bodies may import lazily): a
    parent that never imports torch loads these files by path."""
    tree = ast.parse((REPO / "raft_tpu_torch" / rel).read_text())
    roots = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert roots <= {"__future__", "argparse", "json", "math", "os", "sys",
                     "threading", "time", "typing"}, roots


def _faultpoint_sites(path):
    tree = ast.parse(path.read_text())
    return sorted(
        node.args[0].value for node in ast.walk(tree)
        if isinstance(node, ast.Call) and node.args
        and isinstance(node.args[0], ast.Constant)
        and (getattr(node.func, "attr", None) == "faultpoint"
             or getattr(node.func, "id", None) == "faultpoint"))


@pytest.mark.parametrize("rel,sites", [
    ("obs/flight.py", ["obs.flight.sample"]),
    ("tuning/autotune.py", ["tuning.autotune.window"]),
    ("serving/controller.py", ["serving.controller.tick"])])
def test_tuning_faultpoints_are_named_as_in_jax(rel, sites):
    got = [_faultpoint_sites(REPO / pkg / rel)
           for pkg in ("raft_tpu", "raft_tpu_torch")]
    assert got == [sites, sites], (rel, got)


#: the JAX modules' try statements, each classifying a failure into a
#: verdict, a degraded section or a skipped window/tick; the port keeps
#: exactly these and adds none
_OBS_TUNING_TRIES = {"serving/controller.py": 4, "tuning/autotune.py": 4,
                     "obs/flight.py": 6, "obs/slo.py": 3,
                     "obs/report.py": 3, "obs/explain.py": 0,
                     "obs/aggregate.py": 5, "bench/progress.py": 7}


@pytest.mark.parametrize("rel", sorted(_OBS_TUNING_TRIES))
def test_obs_and_tuning_keep_the_jax_try_blocks_and_add_none(rel):
    trees = [ast.parse((REPO / pkg / rel).read_text())
             for pkg in ("raft_tpu", "raft_tpu_torch")]
    counts = [sum(isinstance(n, ast.Try) for n in ast.walk(t))
              for t in trees]
    assert counts == [_OBS_TUNING_TRIES[rel]] * 2, (rel, counts)


@pytest.mark.parametrize("rel", ["bench/runner.py", "bench/io.py",
                                 "random/generators.py"])
def test_no_try_on_the_runner_path(rel):
    """The runner drives K1 and K6 on the card: a CUDA tensor gets the
    kernel or an exception, never a quiet detour."""
    tree = ast.parse((REPO / "raft_tpu_torch" / rel).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], rel


# the sparse tier, graph clustering, the hybrid and out-of-core paths:
# modules at the JAX paths, importing no JAX, with no try statement (the
# JAX modules have none either), so a CUDA tensor on the hybrid path gets
# K2 / K4 or an exception, and an OOM reaches only degrade_on_oom
SPARSE_GRAPH_HYBRID_MODULES = (
    "sparse/__init__.py", "sparse/types.py", "sparse/convert.py",
    "sparse/op.py", "sparse/linalg.py", "sparse/distance.py",
    "sparse/neighbors.py", "sparse/solver.py", "label/__init__.py",
    "label/classlabels.py", "cluster/single_linkage.py",
    "spectral/__init__.py", "spectral/partition.py", "neighbors/hybrid.py",
    "neighbors/batch_knn.py", "neighbors/ball_cover.py",
    "neighbors/epsilon_neighborhood.py")


@pytest.mark.parametrize("rel", SPARSE_GRAPH_HYBRID_MODULES)
def test_sparse_graph_hybrid_modules_mirror_jax_and_add_no_try(rel):
    trees = [ast.parse((REPO / pkg / rel).read_text())
             for pkg in ("raft_tpu", "raft_tpu_torch")]
    assert REPO / "raft_tpu_torch" / rel in _port_files()
    roots = {m.split(".")[0]
             for m in _imported_modules(REPO / "raft_tpu_torch" / rel)}
    assert not roots & {"jax", "jaxlib", "raft_tpu"}, rel
    counts = [sum(isinstance(n, ast.Try) for n in ast.walk(t))
              for t in trees]
    assert counts == [0, 0], (rel, counts)
    # the public names of the JAX module are the port's
    public = [{n.name for n in t.body
               if isinstance(n, (ast.FunctionDef, ast.ClassDef))
               and not n.name.startswith("_")} for t in trees]
    assert public[0] <= public[1], (rel, public[0] - public[1])


@pytest.mark.parametrize("rel,sites", [
    ("neighbors/batch_knn.py", ["batch_knn.search_device_chunked",
                                "batch_knn.search_out_of_core.chunk"])])
def test_batch_knn_faultpoints_are_named_as_in_jax(rel, sites):
    got = [_faultpoint_sites(REPO / pkg / rel)
           for pkg in ("raft_tpu", "raft_tpu_torch")]
    assert got == [sites, sites], (rel, got)
