"""Launch-region resolver: which functions of a module drive the card's
kernels back to back (counterpart of ``raft_tpu/analysis/jit_regions.py``,
which resolves jit/pallas regions).

The host-sync and tensor-branch rules are only meaningful INSIDE a stretch
that should stay on the device. Under JAX that stretch is a traced region;
eager torch has no tracer, so the port's stretch is where it launches its
hand-written kernels or hands code to a graph compiler. ``int(t)`` on a
CUDA tensor there stalls the host until the card has drained every launch
queued before it, and the next launch waits for the host. This module
answers "is this ast node inside a launch region?" from one file's AST:

1. **Direct roots** —
   * functions that launch a hand kernel through ``ops/_native``: they call
     its launchers (``_native.load(...)``, ``_native.last_loop(...)``) or
     count a launch on a module-level :class:`KernelCounter`
     (``STRIP_KERNEL.launches += 1``);
   * functions wrapped by ``torch.compile``, ``torch.jit.script`` /
     ``torch.jit.trace`` or ``torch.cuda.make_graphed_callables``
     (decorated, rebound ``f = torch.compile(f)`` or passed inline);
   * the body of a ``with torch.cuda.graph(g):`` capture, and the functions
     it calls by bare name.
2. **Call-graph closure** — a helper called (by bare name, same module)
   from a region function runs inside the same stretch; reachability is a
   BFS over local call edges. Cross-module calls are out of scope by
   design, as in the JAX resolver.
3. **Lexical nesting** — a function defined inside a region function is in
   the region.

``params_are_tensors(fn)`` is true for functions handed to a graph
compiler: every parameter but ``self`` arrives as a tensor there (the
counterpart of JAX's non-static parameters of a direct jit root). A kernel
launcher's parameters are a mix of tensors and host ints, so they stay
untainted.
"""

from __future__ import annotations

import ast
from collections import deque
from typing import Dict, List, Set

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)
_SCOPES = _FUNC_NODES + (ast.Module, ast.ClassDef)

#: the ``ops/_native`` functions a kernel wrapper launches through
_LAUNCHERS = {"load", "last_loop"}

#: wrappers that compile or capture their function argument
_COMPILERS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
              "torch.cuda.make_graphed_callables"}

#: context managers whose body is captured into a CUDA graph
_CAPTURES = {"torch.cuda.graph"}


def walk(node: ast.AST) -> List[ast.AST]:
    """``ast.walk``'s nodes in its order, over the child lists the walker
    caches on every parsed node (``_children``): the rules walk each module
    and function many times, and ``ast.iter_child_nodes`` dominated their
    time. A module's, class's or function's walk is itself cached. A node
    without the child cache (a snippet parsed on the side) falls back to
    ``ast.iter_child_nodes``."""
    cached = getattr(node, "_walk", None)
    if cached is not None:
        return cached
    out = []
    todo = deque([node])
    while todo:
        cur = todo.popleft()
        children = getattr(cur, "_children", None)
        todo.extend(ast.iter_child_nodes(cur) if children is None
                    else children)
        out.append(cur)
    if isinstance(node, _SCOPES) and hasattr(node, "_children"):
        node._walk = out
    return out


def dotted_name(node: ast.AST) -> str:
    """``torch.cuda.synchronize`` for a Name/Attribute chain, '' for
    anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def resolve_name(imports: Dict[str, str], node: ast.AST) -> str:
    """Canonical dotted name with the module's import aliases folded in:
    ``F.relu`` -> ``torch.nn.functional.relu``, ``_native.load`` ->
    ``raft_tpu_torch.ops._native.load``."""
    name = dotted_name(node)
    if not name:
        return ""
    head, _, rest = name.partition(".")
    origin = imports.get(head)
    if origin:
        return f"{origin}.{rest}" if rest else origin
    return name


def is_launcher_call(imports: Dict[str, str], call: ast.Call) -> bool:
    """``_native.load(...)`` / ``_native.last_loop(...)`` however
    ``_native`` was imported."""
    resolved = resolve_name(imports, call.func)
    mod, _, tail = resolved.rpartition(".")
    return tail in _LAUNCHERS and mod.rsplit(".", 1)[-1] == "_native"


def _counter_names(tree: ast.Module, imports: Dict[str, str]) -> Set[str]:
    """Module-level names bound to a ``KernelCounter(...)``."""
    out: Set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call) \
                and resolve_name(imports, stmt.value.func).endswith(
                    "KernelCounter"):
            out.update(t.id for t in stmt.targets if isinstance(t, ast.Name))
    return out


def _counts_a_launch(node: ast.AST, counters: Set[str]) -> bool:
    """``X.launches += 1`` on a module-level kernel counter."""
    return (isinstance(node, ast.AugAssign)
            and isinstance(node.target, ast.Attribute)
            and node.target.attr == "launches"
            and isinstance(node.target.value, ast.Name)
            and node.target.value.id in counters)


class LaunchRegions:
    """Per-module launch-region index. Expects parent links on the tree
    (``walker`` sets ``node.parent``)."""

    def __init__(self, tree: ast.Module, imports: Dict[str, str]):
        self._funcs: Dict[str, List[ast.AST]] = {}
        roots: Set[ast.AST] = set()
        self._compiled: Set[ast.AST] = set()
        self._captures: Set[ast.AST] = set()
        counters = _counter_names(tree, imports)

        for node in walk(tree):
            if isinstance(node, _FUNC_NODES):
                self._funcs.setdefault(node.name, []).append(node)

        def mark_name(name_node: ast.AST, compiled: bool) -> None:
            if isinstance(name_node, ast.Name):
                for fn in self._funcs.get(name_node.id, ()):
                    roots.add(fn)
                    if compiled:
                        self._compiled.add(fn)

        captured_calls: List[ast.Call] = []
        for node in walk(tree):
            if isinstance(node, _FUNC_NODES):
                for deco in node.decorator_list:
                    target = deco.func if isinstance(deco, ast.Call) else deco
                    if resolve_name(imports, target) in _COMPILERS:
                        roots.add(node)
                        self._compiled.add(node)
            elif isinstance(node, ast.Call):
                if resolve_name(imports, node.func) in _COMPILERS \
                        and node.args:
                    mark_name(node.args[0], True)
                elif is_launcher_call(imports, node):
                    roots.update(self.enclosing_functions(node)[:1])
            elif _counts_a_launch(node, counters):
                roots.update(self.enclosing_functions(node)[:1])
            elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    isinstance(item.context_expr, ast.Call)
                    and resolve_name(imports, item.context_expr.func)
                    in _CAPTURES for item in node.items):
                self._captures.add(node)
                captured_calls.extend(
                    sub for stmt in node.body for sub in walk(stmt)
                    if isinstance(sub, ast.Call))
        for call in captured_calls:
            mark_name(call.func, False)

        # call-graph closure over bare-name calls; lexical nesting is
        # resolved lazily in in_region() by climbing parents
        self._region: Set[ast.AST] = set(roots)
        frontier = list(roots)
        while frontier:
            fn = frontier.pop()
            for node in walk(fn):
                if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                    for callee in self._funcs.get(node.func.id, ()):
                        if callee not in self._region:
                            self._region.add(callee)
                            frontier.append(callee)

    def functions_named(self, name: str) -> List[ast.AST]:
        """The module's function defs named ``name`` (any nesting)."""
        return self._funcs.get(name, [])

    def enclosing_functions(self, node: ast.AST) -> List[ast.AST]:
        """Innermost-first chain of function defs containing ``node``."""
        chain = []
        cur = getattr(node, "parent", None)
        while cur is not None:
            if isinstance(cur, _FUNC_NODES):
                chain.append(cur)
            cur = getattr(cur, "parent", None)
        return chain

    def in_region(self, node: ast.AST) -> bool:
        """Is ``node`` (any ast node) inside a launch region?"""
        if isinstance(node, _FUNC_NODES) and node in self._region:
            return True
        cur = getattr(node, "parent", None)
        while cur is not None:
            if cur in self._region or cur in self._captures:
                return True
            cur = getattr(cur, "parent", None)
        return False

    def params_are_tensors(self, fn: ast.AST) -> bool:
        """Was ``fn`` handed to ``torch.compile`` / ``torch.jit``? Its
        parameters then arrive as tensors."""
        return fn in self._compiled
