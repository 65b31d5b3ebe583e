"""span-name: the span-tree contract, mechanically enforced (counterpart of
``raft_tpu/analysis/rules/span_name.py``).

Two halves of the observability contract:

* **Naming.** Every literal span name — ``@traced("…")`` decorators and
  ``record_span("…")`` calls — in library code (``raft_tpu_torch/``,
  ``bench.py``)
  must follow the ``module::phase`` convention (lower-case dotted segments
  either side of one ``::``). The convention is what makes trace trees,
  fleet merges and the bench comparator line up across rounds: a span that
  renames itself or free-forms its name silently forks its metric series.
  Tests and scripts are out of scope (they open scratch spans).

* **Export channel.** In bench scope (``bench.py``,
  ``raft_tpu_torch/bench/``), direct calls to ``export_jsonl`` /
  ``export_chrome_trace`` bypass ``bench/progress.py``'s crash-safe
  channel (fsync'd, salvage-aware) and get flagged; ``progress.py`` itself is exempt.
  Route through ``progress.export_metrics`` / ``progress.write_artifact``.
"""

from __future__ import annotations

import ast
import re

from raft_tpu_torch.analysis.registry import Rule, register
from raft_tpu_torch.analysis.jit_regions import dotted_name, walk

_NAME_RE = re.compile(
    r"^[a-z0-9_]+(\.[a-z0-9_]+)*::[a-z0-9_]+(\.[a-z0-9_]+)*$")

_EXPORT_CALLS = {"export_jsonl", "export_chrome_trace"}


def _literal_span_names(tree):
    """Yield (node, name) for every literal span name in the module: the
    first argument of record_span(...) calls and of traced(...) decorators."""
    for node in walk(tree):
        if isinstance(node, ast.Call) and \
                dotted_name(node.func).rsplit(".", 1)[-1] == "record_span" \
                and node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            yield node, node.args[0].value
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for deco in node.decorator_list:
                if isinstance(deco, ast.Call) and \
                        dotted_name(deco.func).rsplit(".", 1)[-1] == "traced" \
                        and deco.args and \
                        isinstance(deco.args[0], ast.Constant) and \
                        isinstance(deco.args[0].value, str):
                    yield deco, deco.args[0].value


@register
class SpanNameRule(Rule):
    id = "span-name"
    severity = "error"
    description = ("span names must follow module::phase; bench telemetry "
                   "exports must route through bench/progress.py")

    def check(self, ctx):
        parts = ctx.rel.split("/")
        in_library = parts[0] == "raft_tpu_torch" or ctx.rel == "bench.py"
        in_bench = ctx.rel == "bench.py" or "bench" in parts[:-1]

        in_serving = len(parts) > 1 and parts[0] == "raft_tpu_torch" \
            and parts[1] == "serving"
        if in_library:
            for node, name in _literal_span_names(ctx.tree):
                if not _NAME_RE.match(name):
                    yield self.finding(
                        ctx, node,
                        f"span name {name!r} breaks the module::phase "
                        f"convention (lower-case dotted segments around one "
                        f"'::') — renamed spans fork their metric series "
                        f"across rounds")
                elif in_serving and not name.startswith(
                        ("serving::", "capacity::")):
                    # the serving layer's span family is its SLO dashboard:
                    # a span filed under another module's prefix silently
                    # drops out of every serving-latency query. The
                    # capacity:: family — the multi-tenant
                    # admission/tiering plane lives in serving/ but its
                    # spans (capacity::admit/demote/promote/search) are
                    # their own dashboard
                    yield self.finding(
                        ctx, node,
                        f"span name {name!r} in raft_tpu_torch/serving/ must use "
                        f"the serving:: or capacity:: prefix "
                        f"(serving::phase naming)")

        if in_bench and not ctx.rel.endswith("/progress.py"):
            for node in walk(ctx.tree):
                if not isinstance(node, ast.Call):
                    continue
                tail = dotted_name(node.func).rsplit(".", 1)[-1]
                if tail in _EXPORT_CALLS:
                    yield self.finding(
                        ctx, node,
                        f"direct {tail}() in bench code bypasses the "
                        f"crash-safe bench/progress.py channel — use "
                        f"progress.export_metrics / progress.write_artifact "
                        f"(fsync'd, salvageable) instead")
