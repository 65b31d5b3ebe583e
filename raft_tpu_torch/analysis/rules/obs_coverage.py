"""obs-coverage: telemetry is a prerequisite, mechanically enforced
(counterpart of ``raft_tpu/analysis/rules/obs_coverage.py``).

Bench-affecting hot paths must keep their ``raft_tpu_torch.obs`` spans.
This rule turns that from review-time lore into a tier-1 failure: every
PUBLIC build/search/fit-family entry point in ``neighbors/``,
``cluster/``, ``distributed/`` and ``serving/`` must either carry the
``@traced("…")`` decorator or open an ``obs.record_span`` itself.
Removing a span from an instrumented entry point — or adding a new entry
point without one — is a NEW finding and fails the run (the baseline never
absorbs it, because the identity line is the ``def`` itself).

The serving layer's public surface is method-shaped
(``PagedListStore.upsert`` / ``.delete`` / ``.compact``,
``QueryQueue.submit``), so inside ``serving/`` the rule also walks
class bodies.

The observability plane's own entry points are in scope too, per file:
the SLO engine and status report (``obs/slo.py`` / ``obs/report.py``:
``sample`` / ``evaluate`` / ``collect`` / ``render``) that the autotuner
and the controller consume; the dispatch cost model and compile ledger
(``obs/costmodel.py`` / ``obs/compile.py``: ``estimate`` /
``check_admission`` / ``predict_index_bytes`` / ``summary``), the
admission controller's inputs; the roofline plane (``obs/roofline.py``:
``estimate_flops`` / ``utilization`` / ``summary``); and the flight
recorder (``obs/flight.py``: ``sample`` / ``render`` /
``extract_frontier``). The watcher is watched. ``trace_event``,
``note_dispatch`` and ``maybe_sample`` stay exempt: each sits on the hot
path behind its callers' own ``obs.enabled()`` gate.
"""

from __future__ import annotations

import ast

from raft_tpu_torch.analysis.registry import Rule, register
from raft_tpu_torch.analysis.rules._common import calls_record_span, is_traced_decorated

_SCOPED_DIRS = {"neighbors", "cluster", "distributed", "serving"}
#: ``promote``/``demote``: the capacity plane's tier moves are
#: serving-path policy actions — an unobserved demotion is an invisible
#: recall hit, so they are entry points like search/upsert
_ENTRY_NAMES = {"build", "search", "fit", "fit_predict", "extend", "knn",
                "upsert", "delete", "submit", "compact", "promote",
                "demote"}
_ENTRY_PREFIXES = ("build_", "search_", "fit_")

#: the obs plane's own public entry points, scoped per file so helper
#: modules (aggregate, tracing) keep their non-span shape
_OBS_FILES = {"slo.py", "report.py", "costmodel.py", "compile.py",
              "roofline.py", "flight.py"}
_OBS_ENTRY_NAMES = {"sample", "evaluate", "collect", "render",
                    "estimate", "check_admission", "predict_index_bytes",
                    "summary", "estimate_flops", "utilization",
                    "extract_frontier"}


def _is_entry_name(name: str) -> bool:
    if name.startswith("_"):
        return False
    return name in _ENTRY_NAMES or name.startswith(_ENTRY_PREFIXES)


def _is_obs_entry_name(name: str) -> bool:
    return not name.startswith("_") and name in _OBS_ENTRY_NAMES


@register
class ObsCoverageRule(Rule):
    id = "obs-coverage"
    severity = "error"
    description = ("public build/search/fit entry points in neighbors/"
                   "cluster/distributed must be @traced or record_span")

    def check(self, ctx):
        parts = ctx.rel.split("/")
        dirs = parts[:-1]
        obs_scoped = "obs" in dirs and parts[-1] in _OBS_FILES
        if not (_SCOPED_DIRS.intersection(dirs) or obs_scoped):
            return
        is_entry = _is_obs_entry_name if obs_scoped else _is_entry_name
        nodes = list(ctx.tree.body)  # module level: the public surface
        if "serving" in dirs or obs_scoped:  # ...plus method-shaped entries
            for node in ctx.tree.body:
                if isinstance(node, ast.ClassDef):
                    nodes.extend(n for n in node.body if isinstance(
                        n, (ast.FunctionDef, ast.AsyncFunctionDef)))
        for node in nodes:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not is_entry(node.name):
                continue
            if is_traced_decorated(node) or calls_record_span(node):
                continue
            yield self.finding(
                ctx, node,
                f"public entry point `{node.name}` has no telemetry span — "
                f"decorate it @traced(\"…\") or open obs.record_span "
                f"(telemetry is a prerequisite)")
