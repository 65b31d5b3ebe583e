"""Standing rules of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points run on CUDA unless asked for the CPU (and raise
rather than fall back), and its kernel wrappers take their plain versions
only for CPU tensors, without counting a launch."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.core.resources import Resources, resolve_device
from raft_tpu_torch.neighbors import brute_force, ivf_pq, refine
from raft_tpu_torch.ops import _native
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
    assert _native.SOURCE.is_file()
    assert _native.SOURCE.parent == _native.CSRC
    assert "_build" in (REPO / ".gitignore").read_text()


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
    bf_cpu = brute_force.build(x, device="cpu")
    return {
        "kmeans_balanced.fit": lambda: kmeans_balanced.fit(
            x, 4, kmeans_balanced.KMeansBalancedParams(n_iters=2), **dev),
        "ivf_pq.build": lambda: ivf_pq.build(x, ivf_pq.IvfPqParams(
            n_lists=4, pq_dim=4, group_size=512, kmeans_n_iters=2,
            codebook_n_iters=2), **dev),
        "ivf_pq.search": lambda: ivf_pq.search(idx_cpu, q, 5, n_probes=2,
                                               **dev),
        "refine": lambda: refine.refine(x, q, np.zeros((16, 8), np.int32), 5,
                                        **dev),
        "brute_force.build": lambda: brute_force.build(x, **dev),
        "brute_force.search": lambda: brute_force.search(bf_cpu, q, 5, **dev),
    }


@pytest.mark.parametrize("name", ["kmeans_balanced.fit", "ivf_pq.build",
                                  "ivf_pq.search", "refine",
                                  "brute_force.build", "brute_force.search"])
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
