"""unused-import: dead imports.

(Counterpart of ``raft_tpu/analysis/rules/imports.py``.) Dead imports in
this tree are not just noise — an ``import torch`` at the top of a
stdlib-only module (``bench/progress.py``, ``obs/aggregate.py``, this
package) costs every parent process that loads it by path the torch cold
start. The rule is pyflakes-shaped but deliberately narrower:

* ``__init__.py`` is skipped wholesale (re-export surface);
* a line carrying ``# noqa`` is skipped (side-effect imports, e.g. rule
  registration);
* names referenced only inside QUOTED annotations (``TYPE_CHECKING``
  blocks) count as used — annotation strings are parsed and mined;
* ``__all__`` string entries count as used.
"""

from __future__ import annotations

import ast
from typing import Dict, Set

from raft_tpu_torch.analysis.jit_regions import walk
from raft_tpu_torch.analysis.registry import Rule, register


def _imported_bindings(tree: ast.Module) -> Dict[str, ast.AST]:
    """Local binding name -> the import node that created it."""
    out: Dict[str, ast.AST] = {}
    for node in walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = node
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for a in node.names:
                if a.name != "*":
                    out[a.asname or a.name] = node
    return out


def _annotation_names(tree: ast.Module) -> Set[str]:
    """Names inside string annotations (``"Iterator[Finding]"``)."""
    out: Set[str] = set()
    anns = []
    for node in walk(tree):
        if isinstance(node, ast.AnnAssign):
            anns.append(node.annotation)
        elif isinstance(node, ast.arg) and node.annotation is not None:
            anns.append(node.annotation)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                node.returns is not None:
            anns.append(node.returns)
    for ann in anns:
        for sub in walk(ann):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                try:
                    parsed = ast.parse(sub.value, mode="eval")
                except SyntaxError:
                    continue
                out.update(n.id for n in walk(parsed)
                           if isinstance(n, ast.Name))
    return out


@register
class UnusedImportRule(Rule):
    id = "unused-import"
    severity = "warning"
    description = "imported name never referenced (non-__init__ modules)"

    def check(self, ctx):
        if ctx.rel.endswith("__init__.py"):
            return
        bindings = _imported_bindings(ctx.tree)
        if not bindings:
            return
        used: Set[str] = {
            n.id for n in walk(ctx.tree) if isinstance(n, ast.Name)}
        used |= _annotation_names(ctx.tree)
        for node in walk(ctx.tree):  # __all__ re-export strings
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "__all__"
                    for t in node.targets):
                for sub in walk(node.value):
                    if isinstance(sub, ast.Constant) and \
                            isinstance(sub.value, str):
                        used.add(sub.value)
        for name, node in sorted(bindings.items()):
            if name in used or name.startswith("_"):
                continue
            if "# noqa" in ctx.snippet(node.lineno):
                continue
            yield self.finding(
                ctx, node,
                f"`{name}` is imported but never used — dead imports cost "
                f"cold-start and can pull torch into stdlib-only paths")
