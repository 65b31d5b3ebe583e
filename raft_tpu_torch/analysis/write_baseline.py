"""Regenerate the port's graftlint baseline — DELIBERATELY (counterpart of
``scripts/analysis_baseline.py``).

    python -m raft_tpu_torch.analysis.write_baseline           # show what would change
    python -m raft_tpu_torch.analysis.write_baseline --write   # rewrite the baseline

The baseline (``raft_tpu_torch/analysis/baseline.json``) grandfathers known
findings so tier-1 only fails on NEW ones. Regeneration is a human act:
this module previews added/removed entries, carries existing
justifications forward, and marks every NEW entry with a TODO placeholder
that ``tests/test_torch_analysis.py`` refuses to ship — so nobody can
silently grandfather a regression. Nothing in the repo calls this
automatically, and nothing should.
"""

from __future__ import annotations

import argparse
import glob
import sys
from pathlib import Path

from raft_tpu_torch.analysis.baseline import DEFAULT_PATH, Baseline
from raft_tpu_torch.analysis.walker import analyze_paths

REPO = DEFAULT_PATH.parents[2]


def scan_paths(root: Path = REPO) -> list:
    """The gate's scan set: the package, the port's tests, ``chip_smoke.py``."""
    tests = sorted(Path(p).relative_to(root).as_posix() for p in
                   glob.glob(str(root / "tests" / "test_torch_*.py")))
    return ["raft_tpu_torch", *tests, "chip_smoke.py"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="actually rewrite the baseline file")
    args = ap.parse_args(argv)

    findings = analyze_paths(scan_paths(), root=REPO)
    previous = Baseline.load(DEFAULT_PATH)
    fresh = Baseline.from_findings(findings, previous=previous)

    old_keys = {(e["rule"], e["path"], e["snippet"]): e
                for e in previous.entries}
    new_keys = {(e["rule"], e["path"], e["snippet"]): e
                for e in fresh.entries}
    added = [k for k in new_keys if k not in old_keys]
    removed = [k for k in old_keys if k not in new_keys]

    for k in sorted(added):
        print(f"+ {k[1]} · {k[0]} · {k[2][:60]}")
    for k in sorted(removed):
        print(f"- {k[1]} · {k[0]} · {k[2][:60]}  (fixed — pruned)")
    print(f"baseline: {len(previous.entries)} -> {len(fresh.entries)} entries "
          f"({len(added)} added, {len(removed)} pruned)")

    if not args.write:
        print("dry run — pass --write to rewrite", file=sys.stderr)
        return 0
    fresh.save(DEFAULT_PATH)
    todo = fresh.todo_entries()
    if todo:
        print(f"NOTE: {len(todo)} new entr{'y' if len(todo) == 1 else 'ies'} "
              f"need a one-line justification before tier-1 will pass:",
              file=sys.stderr)
        for e in todo:
            print(f"  {e['path']} · {e['rule']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
