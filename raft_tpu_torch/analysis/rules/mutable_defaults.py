"""mutable-default: mutable default argument values (counterpart of
``raft_tpu/analysis/rules/mutable_defaults.py``).

The classic: ``def f(x, acc=[])`` evaluates the default ONCE at def time, so
state leaks across calls. In this codebase the sharper version of the bug is
a default ``CagraParams()``-style dataclass with array fields — mutate it in
one call and every later call sees the mutation. The rule flags literal
list/dict/set displays and ``list()``/``dict()``/``set()``/``bytearray()``
constructor defaults; immutable sentinels (None, tuples, frozen params
objects) pass.
"""

from __future__ import annotations

import ast

from raft_tpu_torch.analysis.jit_regions import walk
from raft_tpu_torch.analysis.registry import Rule, register

_MUTABLE_CTORS = {"list", "dict", "set", "bytearray"}
_MUTABLE_NODES = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
                  ast.SetComp)


@register
class MutableDefaultRule(Rule):
    id = "mutable-default"
    severity = "error"
    description = "mutable default argument (shared across calls)"

    def check(self, ctx):
        for node in walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                continue
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]
            for d in defaults:
                bad = isinstance(d, _MUTABLE_NODES) or (
                    isinstance(d, ast.Call) and
                    isinstance(d.func, ast.Name) and
                    d.func.id in _MUTABLE_CTORS)
                if bad:
                    name = getattr(node, "name", "<lambda>")
                    yield self.finding(
                        ctx, d,
                        f"mutable default in `{name}` is evaluated once and "
                        f"shared across calls — use None and create it in "
                        f"the body")
