"""``python -m raft_tpu_torch.analysis`` — the port's graftlint command line.

Examples::

    python -m raft_tpu_torch.analysis raft_tpu_torch tests/test_torch_*.py chip_smoke.py
    python -m raft_tpu_torch.analysis --json raft_tpu_torch/neighbors
    python -m raft_tpu_torch.analysis --list-rules
    python -m raft_tpu_torch.analysis --select mutable-default,banned-api raft_tpu_torch
    python -m raft_tpu_torch.analysis --rule guarded-state --graph out.json raft_tpu_torch

``--rule`` is an alias for ``--select``; ``--graph`` dumps the repo-wide
lock-acquisition graph (locks, held->taken edges with example sites,
cycles, self-deadlocks) as JSON alongside whatever rules run.

Exit codes: 0 = clean (no findings outside the baseline), 1 = new findings,
2 = bad invocation. The default baseline is
``<root>/raft_tpu_torch/analysis/baseline.json``. ``--write-baseline``
exists for ``python -m raft_tpu_torch.analysis.write_baseline``; prefer
that module (it preserves justifications and prints what changed) over
calling the flag directly.

The analysis package itself is pure stdlib (ast + argparse + json) and
takes no device: it reads source, never initialises CUDA and imports no
JAX. ``-m`` necessarily executes ``raft_tpu_torch/__init__``, which
imports torch, so a run pays that cold start once.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

from raft_tpu_torch.analysis.baseline import Baseline
from raft_tpu_torch.analysis.findings import format_json, format_text
from raft_tpu_torch.analysis.registry import all_rules, resolve
from raft_tpu_torch.analysis.walker import analyze_paths, collect_files

DEFAULT_BASELINE = "raft_tpu_torch/analysis/baseline.json"


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.analysis",
        description="graftlint: torch/CUDA-aware static analysis of "
                    "the port",
    )
    p.add_argument("paths", nargs="*", default=[],
                   help="files / directories to analyze")
    p.add_argument("--root", default=".",
                   help="repo root for relative paths + default baseline "
                        "(default: cwd)")
    p.add_argument("--baseline", default=None,
                   help=f"baseline file (default: <root>/{DEFAULT_BASELINE})")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, grandfathered or not")
    p.add_argument("--write-baseline", action="store_true",
                   help="rewrite the baseline to cover current findings "
                        "(use python -m "
                        "raft_tpu_torch.analysis.write_baseline)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit JSON instead of text")
    p.add_argument("--select", "--rule", default=None, dest="select",
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--graph", default=None, metavar="PATH",
                   help="dump the repo-wide lock-acquisition graph (locks, "
                        "held->taken edges with example sites, cycles) as "
                        "JSON to PATH")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.id:22s} {rule.severity:8s} {rule.description}")
        return 0

    if not args.paths:
        print("graftlint: no paths given (try: raft_tpu_torch "
              "tests/test_torch_*.py chip_smoke.py)", file=sys.stderr)
        return 2

    rules = None
    if args.select:
        if args.write_baseline:
            # from_findings covers the current findings EXACTLY — a partial
            # rule selection would silently delete every other grandfathered
            # entry (and its handwritten justification) from the file.
            print("graftlint: --write-baseline with --select would drop all "
                  "entries for unselected rules; run without --select "
                  "(prefer python -m raft_tpu_torch.analysis."
                  "write_baseline)", file=sys.stderr)
            return 2
        try:
            rules = resolve(s.strip() for s in args.select.split(",") if s.strip())
        except KeyError as e:
            print(f"graftlint: {e.args[0]}", file=sys.stderr)
            return 2

    root = Path(args.root).resolve()
    baseline_path = Path(args.baseline) if args.baseline else root / DEFAULT_BASELINE

    if args.graph:
        import json

        from raft_tpu_torch.analysis.projectgraph import ProjectContext
        from raft_tpu_torch.analysis.walker import parse_module

        try:
            files = collect_files(args.paths, root=root)
        except FileNotFoundError as e:
            print(str(e), file=sys.stderr)
            return 2
        contexts = []
        for path in files:
            try:
                contexts.append(parse_module(path, root))
            except SyntaxError:
                pass  # the lint pass below reports it as parse-error
        project = ProjectContext(contexts, root)
        payload = project.lock_graph_json()
        Path(args.graph).write_text(
            json.dumps(payload, indent=2) + "\n", encoding="utf-8")
        print(f"graftlint: lock graph ({len(payload['locks'])} locks, "
              f"{len(payload['edges'])} edges, "
              f"{len(payload['cycles'])} cycle(s)) -> {args.graph}",
              file=sys.stderr)

    t0 = time.monotonic()
    try:
        findings = analyze_paths(args.paths, rules=rules, root=root)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 2

    if args.write_baseline:
        previous = Baseline.load(baseline_path)
        # A rewrite covers the scanned findings EXACTLY, so scanning a
        # subset of the tree would silently delete every entry (and its
        # handwritten justification) for files outside that subset. Refuse
        # when an existing entry's file is real but was not scanned —
        # entries for deleted files still prune legitimately.
        scanned = {os.path.relpath(f, root).replace(os.sep, "/")
                   for f in collect_files(args.paths, root=root)}
        orphaned = sorted({e.get("path", "") for e in previous.entries
                           if e.get("path") not in scanned
                           and (root / e.get("path", "")).exists()})
        if orphaned:
            print("graftlint: --write-baseline over a partial scan would "
                  "drop existing entries for unscanned files "
                  f"({', '.join(orphaned)}); scan the full set or use "
                  "python -m raft_tpu_torch.analysis.write_baseline",
                  file=sys.stderr)
            return 2
        Baseline.from_findings(findings, previous=previous).save(baseline_path)
        print(f"graftlint: baseline rewritten with {len(findings)} finding(s)"
              f" -> {baseline_path}", file=sys.stderr)
        return 0

    absorbed = 0
    if not args.no_baseline:
        findings, absorbed = Baseline.load(baseline_path).filter(findings)

    out = (format_json(findings, absorbed) if args.as_json
           else format_text(findings, absorbed))
    print(out)
    elapsed = time.monotonic() - t0
    print(f"graftlint: analyzed in {elapsed:.2f}s", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
