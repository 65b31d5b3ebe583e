"""File discovery, parsing, and rule dispatch (counterpart of
``raft_tpu/analysis/walker.py``).

One :class:`ModuleContext` per file carries everything rules need — the AST
(with ``.parent`` links added so rules can climb), raw source lines for
snippets, the module's import table, the lazy launch-region index, and
inline suppressions (``# graftlint: ignore`` or
``# graftlint: ignore[rule-id]`` on the offending line). The suppression
comment is the JAX package's, so one comment silences both tools.

``analyze_paths`` is the library entry the CLI and tests share: collect,
parse, run every rule, drop suppressed findings, return the rest sorted.
A file that fails to parse yields a single ``parse-error`` finding instead
of killing the run (tier-1 must report, not crash, on a bad checkout).
"""

from __future__ import annotations

import ast
import os
import re
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

from raft_tpu_torch.analysis.findings import Finding, sort_findings
from raft_tpu_torch.analysis.jit_regions import LaunchRegions, walk

_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules", "results",
              "build", "dist", ".eggs", "archive"}

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*ignore(?:\[([A-Za-z0-9_,\- ]+)\])?")


@dataclass
class ModuleContext:
    """Parsed module + per-file indexes handed to every rule."""

    path: Path
    rel: str                       # repo-relative, forward slashes
    tree: ast.Module
    lines: List[str]
    imports: Dict[str, str] = field(default_factory=dict)
    _regions: Optional[LaunchRegions] = None
    #: the repo-wide ProjectContext for this scan (set by analyze_paths);
    #: None when a rule is driven over a lone hand-built context
    project: Optional[object] = None

    @property
    def regions(self) -> LaunchRegions:
        if self._regions is None:
            self._regions = LaunchRegions(self.tree, self.imports)
        return self._regions

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def suppressed(self, line: int, rule_id: str) -> bool:
        m = _SUPPRESS_RE.search(self.snippet(line))
        if not m:
            return False
        if m.group(1) is None:
            return True
        wanted = {s.strip() for s in m.group(1).split(",")}
        return rule_id in wanted


def _import_table(tree: ast.Module) -> Dict[str, str]:
    """Local name -> dotted origin (``np`` -> ``numpy``, ``F`` ->
    ``torch.nn.functional``, ``partial`` -> ``functools.partial``). A plain
    ``import torch.cuda`` binds ``torch``, so it maps ``torch`` to
    ``torch``."""
    table: Dict[str, str] = {}
    for node in walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    table[a.asname] = a.name
                else:
                    head = a.name.split(".")[0]
                    table[head] = head
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                if a.name == "*":
                    continue
                table[a.asname or a.name] = f"{node.module}.{a.name}"
    return table


def _link_parents(tree: ast.Module) -> None:
    """``.parent`` on every node, and its child list (``_children``) for
    :func:`~raft_tpu_torch.analysis.jit_regions.walk`."""
    todo = deque([tree])
    while todo:
        node = todo.popleft()
        node._children = children = list(ast.iter_child_nodes(node))
        for child in children:
            child.parent = node  # type: ignore[attr-defined]
        todo.extend(children)


def parse_module(path: Path, root: Path) -> ModuleContext:
    """Parse one file into a ModuleContext (raises SyntaxError upward)."""
    source = path.read_text(encoding="utf-8", errors="replace")
    tree = ast.parse(source, filename=str(path))
    _link_parents(tree)
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    return ModuleContext(
        path=path,
        rel=rel,
        tree=tree,
        lines=source.splitlines(),
        imports=_import_table(tree),
    )


def collect_files(paths: Sequence, root: Optional[Path] = None) -> List[Path]:
    """Expand files/dirs into a sorted, deduped .py file list.

    A path that is neither an existing ``.py`` file nor a directory raises
    ``FileNotFoundError``: a typo'd scan target must fail the gate loudly,
    not shrink it to a green no-op (``bench.pyy`` scanning nothing and
    exiting 0 would be the exact silent-pass failure the baseline machinery
    exists to prevent).
    """
    root = Path(root) if root else Path.cwd()
    out: Set[Path] = set()
    for p in paths:
        p = Path(p)
        if not p.is_absolute():
            p = root / p
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not _SKIP_DIRS.intersection(f.relative_to(p).parts[:-1]):
                    out.add(f)
        elif p.suffix == ".py" and p.exists():
            out.add(p)
        else:
            raise FileNotFoundError(
                f"graftlint: scan path {p} is neither a .py file nor a "
                f"directory")
    return sorted(out)


def analyze_paths(paths: Sequence, rules: Optional[Iterable] = None,
                  root: Optional[Path] = None) -> List[Finding]:
    """Run ``rules`` (default: the full registry) over ``paths``."""
    from raft_tpu_torch.analysis.registry import all_rules

    from raft_tpu_torch.analysis.projectgraph import ProjectContext

    root = Path(root) if root else Path.cwd()
    active = list(rules) if rules is not None else all_rules()
    findings: List[Finding] = []
    # two-phase: parse everything first so interprocedural rules see the
    # whole scan set (call graph, lock table, faultpoint/arming inventory)
    # through ctx.project, then dispatch rules file by file as before
    contexts: List[ModuleContext] = []
    for path in collect_files(paths, root):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        try:
            contexts.append(parse_module(path, root))
        except SyntaxError as e:
            findings.append(Finding(
                path=rel, line=e.lineno or 0, rule="parse-error",
                severity="error", message=f"cannot parse: {e.msg}"))
    project = ProjectContext(contexts, root)
    for ctx in contexts:
        ctx.project = project
        for rule in active:
            for f in rule.check(ctx):
                if not ctx.suppressed(f.line, f.rule):
                    findings.append(f)
    return sort_findings(findings)
