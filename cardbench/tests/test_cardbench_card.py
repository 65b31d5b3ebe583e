"""One short run of each cell on the card, through ``cardbench/run.py``.
Skips without a card."""

import json
import subprocess
import sys

import pytest

from cardbench.tests.tiny import REPO

CELLS = ["sift1m-ivfpq.b10k", "sift1m-ivfpq.b10k-filter10",
         "sift1m-ivfpq.build", "deep10m-ivfpq.b10k"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload", workload,
         "--seed", "4000000001", "--seconds", "2", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
