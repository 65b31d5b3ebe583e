"""Nothing the benchmark runs loads JAX or the JAX package, the reference
loads nothing of the port, and a run with no card or no port prints no
result."""

import json
import subprocess
import sys

from cardbench.harness import forbidden_modules
from cardbench.tests.tiny import REPO, make_root


def test_forbidden_names_are_compared_whole():
    assert forbidden_modules({"raft_tpu_torch", "raft_tpu_torch.ops",
                              "numpy", "jaxtyping", "flaxen"}) == []
    assert forbidden_modules({"raft_tpu", "raft_tpu.core.bitset"}) == \
        ["raft_tpu"]
    assert forbidden_modules({"jax.numpy", "jaxlib", "flax.linen"}) == \
        ["flax", "jax", "jaxlib"]


def _modules_after(code: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted(sys.modules)))"],
        cwd=REPO, capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_loops_and_port_load_no_jax():
    mods = _modules_after(
        "from pathlib import Path\n"
        "from cardbench import harness, control, trace, window\n"
        "from cardbench.reference import knn, judge, precision\n"
        "from cardbench.roofline import ivf_scan, peaks\n"
        "root = harness.ROOT / 'cardbench'\n"
        "for sub in ('loops', 'metrics', 'data'):\n"
        "    for f in sorted((root / sub).glob('*.py')):\n"
        "        harness.load_module(f, sub + '_' + f.stem)\n"
        "from raft_tpu_torch.neighbors import ivf_pq, refine\n"
        "from raft_tpu_torch.core.bitset import Bitset\n")
    assert "raft_tpu_torch" in mods
    assert forbidden_modules(mods) == []


def test_reference_and_generators_load_nothing_of_the_port():
    mods = _modules_after(
        "from cardbench import harness\n"
        "from cardbench.reference import knn, judge, precision\n"
        "from cardbench.roofline import ivf_scan, peaks\n"
        "for f in sorted((harness.ROOT / 'cardbench' / 'data')"
        ".glob('*.py')):\n"
        "    harness.load_module(f, 'data_' + f.stem)\n")
    assert not [m for m in mods if m.split(".")[0].startswith("raft_tpu")]


def test_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload",
         "sift1m-ivfpq.b10k", "--seed", "3", "--seconds", "1", "--trace",
         "0"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_run_in_a_checkout_without_the_port_fails(tmp_path):
    root = make_root(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, '.')\n"
         "from pathlib import Path\n"
         "from cardbench import harness\n"
         "line = harness.run_cell(Path('.'), 'sift1m-ivfpq.b10k', 3, 0.2,"
         " False, device='cpu')\n"
         "harness.emit(line)\n"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert "raft_tpu_torch" in out.stderr
    assert '"correct"' not in out.stdout
