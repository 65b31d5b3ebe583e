"""The control of a cell's comparison: the reference put in the program's
place, computed in the precision one step below the configuration's
(its ``control.precision``), answering the cell's whole query pool, and
judged exactly as a run's answers are. It has to come out not correct.

    python3 cardbench/control.py --workload <name> --seeds 1,2,3

prints one JSON line per seed with the numbers compared. The benchmark's
own runs never run it."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Optional

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cardbench import harness  # noqa: E402
from cardbench.reference import knn  # noqa: E402
from cardbench.reference.judge import judge_search  # noqa: E402
from cardbench.window import group_answers  # noqa: E402


def control_run(root: Path, workload: str, seed: int,
                device: Optional[str] = None) -> dict:
    """The control's readings for one seed: the cell's rows, pool and
    filter, answered by :func:`knn.scan` at the control precision."""
    import torch

    cell = harness.load_cell(root, workload)
    dev = torch.device(device or "cuda:0")
    r = harness.Run(cell, int(seed), 0.0, False, dev, root,
                    time.perf_counter())
    batch, n_pool = int(cell.traffic["batch"]), int(cell.traffic["pool_batches"])
    rows, queries = r.data(n_pool * batch)
    pool = [queries[i * batch:(i + 1) * batch] for i in range(n_pool)]
    mask = r.filter_mask(rows.shape[0])
    k = int(cell.config["search"]["k"])
    precision = cell.config["control"]["precision"]
    answers, sample = [], []
    for b, qb in enumerate(pool):
        d, ids = knn.scan(rows, qb, k, mask, precision)
        answers.append((b, ids.to(torch.int32).cpu().numpy()))
        sample.append((b, d, ids))
    checks, _ = judge_search(rows, pool, k, group_answers(answers), sample,
                             r.limits(), n_pool, mask)
    return {"workload": workload, "seed": int(seed), "precision": precision,
            "correct": all(c["ok"] for c in checks),
            "checks": {c["name"]: c["value"] for c in checks}}


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    a = p.parse_args(argv)
    for seed in a.seeds.split(","):
        print(json.dumps(control_run(harness.ROOT, a.workload, int(seed))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
