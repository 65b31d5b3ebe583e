"""graftlint for the port: torch/CUDA-aware static analysis of the
``raft_tpu_torch`` tree (counterpart of ``raft_tpu/analysis``).

An AST walk over the port's sources on every tier-1 run, with a pluggable
rule registry aimed at this codebase's real bug classes and a checked-in
baseline, so grandfathered findings stay visible-but-silent while any NEW
finding fails the build. The twelve generic rules are the JAX package's;
its four JAX-idiom rules are recast for torch on CUDA, where the hazard is
the same (the host stalls the device inside what should be a
device-resident stretch) but the syncs are torch's implicit ones:
``.item()``, ``.cpu()``, ``int(t)``, ``if t.any():``, ``torch.nonzero``,
boolean-mask indexing, an f-string of a tensor.

The analyzer is the one entry point of the port that takes no ``device``:
it reads source and nothing else, launches nothing and never initialises
CUDA. It needs only the stdlib (``ast``, ``argparse``, ``json``); running
it with ``-m`` pays the package's ``import torch`` once.

Layout (one module per concern):

* :mod:`raft_tpu_torch.analysis.findings`    — Finding record + text/JSON
  report formats
* :mod:`raft_tpu_torch.analysis.registry`    — pluggable rule registry
  (``@register``)
* :mod:`raft_tpu_torch.analysis.jit_regions` — launch-region resolver
  (which functions launch a hand kernel or run under ``torch.compile`` /
  a CUDA graph capture, incl. same-module call-graph reachability)
* :mod:`raft_tpu_torch.analysis.walker`      — file discovery, parse, rule
  dispatch, inline ``# graftlint: ignore[rule]`` suppression
* :mod:`raft_tpu_torch.analysis.baseline`    — grandfathered-finding store
* :mod:`raft_tpu_torch.analysis.cli`         — ``python -m
  raft_tpu_torch.analysis``
* :mod:`raft_tpu_torch.analysis.write_baseline` — deliberate regeneration
* :mod:`raft_tpu_torch.analysis.rules`       — the rule catalog

Usage::

    python -m raft_tpu_torch.analysis raft_tpu_torch tests/test_torch_*.py chip_smoke.py
    python -m raft_tpu_torch.analysis --list-rules
    python -m raft_tpu_torch.analysis --json raft_tpu_torch

Exit codes: 0 = no new findings, 1 = new findings (not in the baseline),
2 = bad invocation. The baseline is ``raft_tpu_torch/analysis/baseline.json``;
regenerate it DELIBERATELY via ``python -m
raft_tpu_torch.analysis.write_baseline`` — never automatically.
"""

from raft_tpu_torch.analysis.findings import (Finding, Severity, format_json,
                                              format_text)
from raft_tpu_torch.analysis.registry import Rule, all_rules, get_rule, register
from raft_tpu_torch.analysis.walker import (ModuleContext, analyze_paths,
                                            collect_files)
from raft_tpu_torch.analysis.baseline import Baseline

__all__ = [
    "Baseline",
    "Finding",
    "ModuleContext",
    "Rule",
    "Severity",
    "all_rules",
    "analyze_paths",
    "collect_files",
    "format_json",
    "format_text",
    "get_rule",
    "register",
]
