"""A copy of the benchmark cut to a size a CPU test run holds: the same
files, with fewer rows, lists and queries."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent


def make_root(dst: Path, rows: int = 6000, n_lists: int = 32,
              batch: int = 200) -> Path:
    """``dst`` holding ``BENCHMARK.json`` and ``cardbench/``, every
    configuration cut to ``rows`` rows and ``n_lists`` lists, every traffic
    mix to batches of ``batch``."""
    shutil.copytree(REPO / "cardbench", dst / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache",
                                                  "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        f = dst / c["file"]
        cfg = json.loads(f.read_text())
        cfg["data"]["rows"] = rows
        cfg["index"]["n_lists"] = n_lists
        cfg["index"].pop("list_size_cap", None)
        f.write_text(json.dumps(cfg))
    for f in (dst / "cardbench" / "traffic").glob("*.json"):
        tr = json.loads(f.read_text())
        tr["batch"] = batch
        f.write_text(json.dumps(tr))
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return dst
