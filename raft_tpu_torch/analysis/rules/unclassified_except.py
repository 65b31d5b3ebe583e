"""unclassified-except: broad handlers must classify or re-raise
(counterpart of ``raft_tpu/analysis/rules/unclassified_except.py``).

The resilience layer only works if failures actually route through
:func:`raft_tpu_torch.resilience.classify` — a broad ``except Exception``
that stamps ``repr(e)`` and moves on erases the failure class (an OOM or
a hang lost that way cannot be recovered from). Scope is where the
incidents live: ``bench.py`` section guards, the ``distributed/`` paths,
the resilience package (the degraded-mode dispatch gate), the crash-safe
write path (``core/serialize.py`` / ``core/fsio.py``), ``serving/`` (the
query-queue dispatch guard: DEADLINE verdicts, OOM batch halving) and
``obs/`` (the SLO/shadow/report plane degrades on failure by design, and
each degradation is only diagnosable if the kind survives). A broad
handler there must call ``classify(...)`` (directly or via a helper whose
name ends in ``classify`` / the bench ``section_error`` wrapper) or
contain a ``raise``; anything else is a finding. Deliberate holdouts are
baselined with a justification via ``python -m
raft_tpu_torch.analysis.write_baseline``.
"""

from __future__ import annotations

import ast

from raft_tpu_torch.analysis.jit_regions import walk
from raft_tpu_torch.analysis.registry import Rule, register
from raft_tpu_torch.analysis.rules._common import resolve_call
from raft_tpu_torch.analysis.rules.exceptions import _is_broad

#: handler-body call names that count as classification
_CLASSIFY_NAMES = {"classify", "section_error"}


def _in_scope(rel: str) -> bool:
    parts = rel.split("/")
    dirs = parts[:-1]
    if parts[-1] == "bench.py" or "distributed" in dirs or \
            "resilience" in dirs or "serving" in dirs or "obs" in dirs:
        return True
    return "core" in dirs and parts[-1] in ("serialize.py", "fsio.py")


def _handles(handler: ast.ExceptHandler, ctx) -> bool:
    """Does this handler classify the exception or re-raise?"""
    for stmt in handler.body:
        for node in walk(stmt):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.Call):
                name = resolve_call(ctx, node.func).rsplit(".", 1)[-1]
                if name in _CLASSIFY_NAMES:
                    return True
    return False


@register
class UnclassifiedExceptRule(Rule):
    id = "unclassified-except"
    severity = "error"
    description = ("broad except in bench.py / distributed paths that "
                   "neither calls resilience.classify() nor re-raises")

    def check(self, ctx):
        if not _in_scope(ctx.rel):
            return
        for node in walk(ctx.tree):
            if not isinstance(node, ast.Try):
                continue
            for handler in node.handlers:
                if not _is_broad(handler):
                    continue
                if _handles(handler, ctx):
                    continue
                yield self.finding(
                    ctx, handler,
                    "broad except drops the failure class — route it "
                    "through resilience.classify() (or re-raise) so "
                    "OOM/TRANSIENT/DEADLINE recovery can see it")
