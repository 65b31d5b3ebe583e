"""Repo-wide interprocedural indexes for the concurrency-discipline rules
(counterpart of ``raft_tpu/analysis/projectgraph.py``).

Everything per-file stays in :class:`walker.ModuleContext`; this module adds
the cross-file view the interprocedural rule families need:

* a **class table** (``rel::ClassName``) with each class's methods, its
  ``threading`` lock attributes, its ``# guarded-by:`` field annotations
  and its ``# holds:`` method declarations;
* **lock-dominance** resolution: whether an attribute access is inside a
  ``with self._lock:`` scope, or inside a method that provably only runs
  with the lock held (construction methods, ``*_locked`` names, ``# holds:``
  declarations, and a fixed point over intra-class call sites);
* the **lock-acquisition graph**: which locks are held when another is
  taken, following calls through a best-effort intra-repo call graph, with
  reentrancy-aware self-edges and SCC-based cycle detection;
* **faultpoint** and **env-knob** site inventories for the contract rules.

Annotation grammar (one comment, on the line of the assignment)::

    self._ring = deque()          # guarded-by: _lock
    self._window = 0              # guarded-by: _lock, reads-ok
    _SPANS = deque(maxlen=cap)    # guarded-by: _LOCK        (module level)

``reads-ok`` tolerates unlocked *reads* — the snapshot-then-release and
monotonic-counter escape patterns — while still requiring every write to
hold the lock. A method that is only ever entered with the lock held but is
called through a non-self receiver (construction-phase helpers like the
store's ``_ingest_packed``) declares it on its ``def`` line::

    def _ingest_packed(self, index):  # holds: _lock

The analysis is deliberately a *may* analysis: unresolvable calls and
attribute receivers are skipped, so it under-approximates the acquisition
graph rather than inventing edges. Flow inside a function is syntactic
(``with`` nesting), which matches how every lock in this repo is taken
except the compaction manager's try-acquire, which guards no annotated
state directly.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from raft_tpu_torch.analysis.jit_regions import walk

_GUARD_RE = re.compile(
    r"#\s*guarded-by:\s*([A-Za-z_][A-Za-z0-9_]*)(\s*,\s*reads-ok)?")
_HOLDS_RE = re.compile(r"#\s*holds:\s*([A-Za-z_][A-Za-z0-9_]*)")

#: threading constructors that create a lock-like object, and whether a
#: second acquisition by the owning thread is legal (reentrant).
_LOCK_CTORS = {
    "Lock": False,
    "RLock": True,
    "Condition": True,      # backed by an RLock unless one is passed in
    "Semaphore": True,      # counting: self-acquire is legal by design
    "BoundedSemaphore": True,
}

#: methods that run before the object is published (or after the last
#: reference dies) — field access there needs no lock by construction.
_CONSTRUCTION_METHODS = {"__init__", "__new__", "__del__", "__post_init__"}

_FAULT_KINDS = ("oom", "transient", "fatal", "delay", "hang")
_ARM_RE = re.compile(
    r"^([A-Za-z0-9_.\-]+)=(" + "|".join(_FAULT_KINDS) + r")(:\d+(:[0-9.]+)?)?$")
_KNOB_PREFIX = "RAFT_TPU_"


@dataclass
class FieldGuard:
    """One ``# guarded-by:`` annotation on a class field or module global."""

    name: str
    lock: str
    reads_ok: bool
    line: int


@dataclass
class ClassInfo:
    rel: str
    name: str
    node: ast.ClassDef
    methods: Dict[str, ast.AST] = field(default_factory=dict)
    locks: Dict[str, str] = field(default_factory=dict)      # attr -> ctor
    guarded: Dict[str, FieldGuard] = field(default_factory=dict)
    holds: Dict[str, Set[str]] = field(default_factory=dict)  # method -> locks
    attr_types: Dict[str, str] = field(default_factory=dict)  # attr -> class key

    @property
    def key(self) -> str:
        return f"{self.rel}::{self.name}"


@dataclass
class LockSite:
    """One acquisition edge example, for reports and the --graph dump."""

    held: str
    taken: str
    rel: str
    line: int


def _call_name(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """Flatten a call target into a dotted name tuple, or None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _lock_ctor(call: ast.AST, imports: Dict[str, str]) -> Optional[str]:
    """``threading.RLock()`` / ``Lock()`` (from-imported) -> ctor name."""
    if not isinstance(call, ast.Call):
        return None
    name = _call_name(call.func)
    if name is None:
        return None
    if len(name) == 2 and imports.get(name[0]) == "threading" \
            and name[1] in _LOCK_CTORS:
        return name[1]
    if len(name) == 1 and name[0] in _LOCK_CTORS \
            and imports.get(name[0]) == f"threading.{name[0]}":
        return name[0]
    return None


def _is_self_attr(node: ast.AST, attr: Optional[str] = None) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and (attr is None or node.attr == attr))


def _enclosing_method(node: ast.AST, cls: ast.ClassDef) -> Optional[ast.AST]:
    """The class method whose body (transitively, through nested defs and
    lambdas) contains ``node`` — or None for class-body code."""
    best = None
    cur = getattr(node, "parent", None)
    while cur is not None and cur is not cls:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and getattr(cur, "parent", None) is cls:
            best = cur
        cur = getattr(cur, "parent", None)
    return best if cur is cls else None


def _with_locks_on_path(node: ast.AST, stop: ast.AST) -> Set[str]:
    """Lock names (self attrs and bare module names) acquired by ``with``
    statements on the ancestor path from ``node`` up to ``stop``."""
    out: Set[str] = set()
    cur = getattr(node, "parent", None)
    while cur is not None and cur is not stop:
        if isinstance(cur, ast.With):
            for item in cur.items:
                expr = item.context_expr
                if _is_self_attr(expr):
                    out.add(expr.attr)
                elif isinstance(expr, ast.Name):
                    out.add(expr.id)
        cur = getattr(cur, "parent", None)
    return out


class ProjectContext:
    """Lazy cross-file indexes shared by every interprocedural rule.

    Built once per :func:`walker.analyze_paths` run over the parsed module
    set; each heavyweight product (class table, acquisition graph, rule
    verdicts) is computed on first use and cached, so scans that select
    only per-file rules pay nothing for it.
    """

    def __init__(self, contexts: List, root) -> None:
        self.contexts = {ctx.rel: ctx for ctx in contexts}
        self.root = root
        self._classes: Optional[Dict[str, ClassInfo]] = None
        self._module_guards: Optional[Dict[str, List[FieldGuard]]] = None
        self._module_locks: Optional[Dict[str, Dict[str, str]]] = None
        self._guarded_cache: Optional[List[tuple]] = None
        self._graph_cache: Optional[dict] = None
        self._summaries: Optional[Dict[str, Set[str]]] = None
        self._faultpoints: Optional[List[tuple]] = None
        self._armings: Optional[List[tuple]] = None
        self._knob_cache: Optional[List[tuple]] = None

    # -- module name resolution ---------------------------------------------

    def rel_for_module(self, dotted: str) -> Optional[str]:
        """``raft_tpu_torch.obs.flight`` -> ``raft_tpu_torch/obs/flight.py`` when that
        file is part of this scan, else None."""
        base = dotted.replace(".", "/")
        for cand in (f"{base}.py", f"{base}/__init__.py"):
            if cand in self.contexts:
                return cand
        return None

    # -- class / guard tables -----------------------------------------------

    @property
    def classes(self) -> Dict[str, ClassInfo]:
        if self._classes is None:
            self._build_tables()
        return self._classes

    @property
    def module_guards(self) -> Dict[str, List[FieldGuard]]:
        """rel -> guarded module-level globals."""
        if self._module_guards is None:
            self._build_tables()
        return self._module_guards

    @property
    def module_locks(self) -> Dict[str, Dict[str, str]]:
        """rel -> {module lock name: ctor}."""
        if self._module_locks is None:
            self._build_tables()
        return self._module_locks

    def _guard_on_line(self, ctx, line: int) -> Optional[Tuple[str, bool]]:
        m = _GUARD_RE.search(ctx.snippet(line))
        if not m:
            return None
        return m.group(1), bool(m.group(2))

    def _build_tables(self) -> None:
        self._classes = {}
        self._module_guards = {}
        self._module_locks = {}
        for rel, ctx in self.contexts.items():
            guards: List[FieldGuard] = []
            locks: Dict[str, str] = {}
            for stmt in ctx.tree.body:
                targets = []
                value = None
                if isinstance(stmt, ast.Assign):
                    targets, value = stmt.targets, stmt.value
                elif isinstance(stmt, ast.AnnAssign):
                    targets, value = [stmt.target], stmt.value
                for t in targets:
                    if not isinstance(t, ast.Name):
                        continue
                    ctor = _lock_ctor(value, ctx.imports)
                    if ctor:
                        locks[t.id] = ctor
                    g = self._guard_on_line(ctx, stmt.lineno)
                    if g:
                        guards.append(FieldGuard(t.id, g[0], g[1], stmt.lineno))
            if guards:
                self._module_guards[rel] = guards
            if locks:
                self._module_locks[rel] = locks
            for node in walk(ctx.tree):
                if isinstance(node, ast.ClassDef):
                    info = self._build_class(ctx, node)
                    self._classes[info.key] = info

    def _build_class(self, ctx, node: ast.ClassDef) -> ClassInfo:
        info = ClassInfo(rel=ctx.rel, name=node.name, node=node)
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info.methods[stmt.name] = stmt
                held = self._holds_decl(ctx, stmt)
                if held:
                    info.holds[stmt.name] = held
            elif isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                # class-level field: X = ... / X: T [= ...]  # guarded-by: L
                t = stmt.targets[0] if isinstance(stmt, ast.Assign) \
                    else stmt.target
                if isinstance(t, ast.Name):
                    g = self._guard_on_line(ctx, stmt.lineno)
                    if g:
                        info.guarded[t.id] = FieldGuard(
                            t.id, g[0], g[1], stmt.lineno)
        for meth in info.methods.values():
            for sub in walk(meth):
                if isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    targets = sub.targets if isinstance(sub, ast.Assign) \
                        else [sub.target]
                    for t in targets:
                        if not _is_self_attr(t):
                            continue
                        ctor = _lock_ctor(sub.value, ctx.imports)
                        if ctor:
                            info.locks[t.attr] = ctor
                        g = self._guard_on_line(ctx, sub.lineno)
                        if g:
                            info.guarded.setdefault(t.attr, FieldGuard(
                                t.attr, g[0], g[1], sub.lineno))
                        tkey = self._attr_class_key(ctx, sub.value)
                        if tkey:
                            info.attr_types[t.attr] = tkey
        return info

    def _holds_decl(self, ctx, meth) -> Set[str]:
        """``# holds: _lock`` on the def line (or the signature lines of a
        multi-line def)."""
        out: Set[str] = set()
        first_body = meth.body[0].lineno if meth.body else meth.lineno + 1
        for line in range(meth.lineno, first_body):
            m = _HOLDS_RE.search(ctx.snippet(line))
            if m:
                out.add(m.group(1))
        return out

    def _attr_class_key(self, ctx, value) -> Optional[str]:
        """``self.x = ClassName(...)`` -> the key of ClassName when it is a
        class in this scan (same module, or a from-import)."""
        if not isinstance(value, ast.Call):
            return None
        name = _call_name(value.func)
        if name is None:
            return None
        if len(name) == 1:
            origin = ctx.imports.get(name[0])
            if origin and "." in origin:
                mod, cls = origin.rsplit(".", 1)
                rel = self.rel_for_module(mod)
                if rel:
                    key = f"{rel}::{cls}"
                    return key
            return f"{ctx.rel}::{name[0]}"
        if len(name) == 2:
            mod = ctx.imports.get(name[0])
            if mod:
                rel = self.rel_for_module(mod)
                if rel:
                    return f"{rel}::{name[1]}"
        return None

    # -- guarded-state ------------------------------------------------------

    def _held_methods(self, info: ClassInfo, lock: str) -> Set[str]:
        """Methods that provably run with ``lock`` held on entry: fixed
        point over construction methods, ``*_locked`` names, ``# holds:``
        declarations, and intra-class self-call sites."""
        held = {
            name for name in info.methods
            if name in _CONSTRUCTION_METHODS
            or name.endswith("_locked")
            or lock in info.holds.get(name, set())
        }
        # collect self-call sites per callee once
        sites: Dict[str, List[ast.AST]] = {}
        for name, meth in info.methods.items():
            for sub in walk(meth):
                if isinstance(sub, ast.Call) and _is_self_attr(sub.func) \
                        and sub.func.attr in info.methods:
                    sites.setdefault(sub.func.attr, []).append(sub)
        changed = True
        while changed:
            changed = False
            for callee, calls in sites.items():
                if callee in held:
                    continue
                ok = True
                for call in calls:
                    meth = _enclosing_method(call, info.node)
                    if meth is None:
                        ok = False
                        break
                    if meth.name in held:
                        continue
                    if lock not in _with_locks_on_path(call, meth):
                        ok = False
                        break
                if ok and calls:
                    held.add(callee)
                    changed = True
        return held

    def guarded_state_results(self) -> List[tuple]:
        """All guarded-state violations project-wide, as
        ``(rel, line, message)`` tuples (cached)."""
        if self._guarded_cache is not None:
            return self._guarded_cache
        out: List[tuple] = []
        for info in self.classes.values():
            out.extend(self._check_class_guards(info))
        for rel, guards in self.module_guards.items():
            out.extend(self._check_module_guards(rel, guards))
        self._guarded_cache = out
        return out

    def _check_class_guards(self, info: ClassInfo) -> List[tuple]:
        out: List[tuple] = []
        held_cache: Dict[str, Set[str]] = {}
        for fname, guard in info.guarded.items():
            if guard.lock not in info.locks:
                out.append((info.rel, guard.line,
                            f"field '{fname}' is guarded-by '{guard.lock}' "
                            f"but {info.name} constructs no threading lock "
                            f"named '{guard.lock}'"))
                continue
            if guard.lock not in held_cache:
                held_cache[guard.lock] = self._held_methods(info, guard.lock)
            held = held_cache[guard.lock]
            for meth in info.methods.values():
                for sub in walk(meth):
                    if not _is_self_attr(sub, fname):
                        continue
                    is_read = isinstance(sub.ctx, ast.Load)
                    if guard.reads_ok and is_read:
                        continue
                    outer = _enclosing_method(sub, info.node)
                    if outer is None or outer.name in held:
                        continue
                    if guard.lock in _with_locks_on_path(sub, outer):
                        continue
                    kind = "read" if is_read else "write"
                    out.append((
                        info.rel, sub.lineno,
                        f"{kind} of {info.name}.{fname} (guarded-by "
                        f"'{guard.lock}') in {outer.name}() is not inside "
                        f"'with self.{guard.lock}:' and {outer.name} is not "
                        f"lock-held on entry"))
        return out

    def _check_module_guards(self, rel: str, guards) -> List[tuple]:
        out: List[tuple] = []
        ctx = self.contexts[rel]
        locks = self.module_locks.get(rel, {})
        for guard in guards:
            if guard.lock not in locks:
                out.append((rel, guard.line,
                            f"global '{guard.name}' is guarded-by "
                            f"'{guard.lock}' but no module-level threading "
                            f"lock of that name exists"))
                continue
            for node in walk(ctx.tree):
                if not (isinstance(node, ast.Name) and node.id == guard.name):
                    continue
                fn = self._enclosing_function(node)
                if fn is None:
                    continue  # module top level: import-time, single thread
                is_read = isinstance(node.ctx, ast.Load)
                if guard.reads_ok and is_read:
                    continue
                if guard.lock in _with_locks_on_path(node, fn):
                    continue
                kind = "read" if is_read else "write"
                out.append((
                    rel, node.lineno,
                    f"{kind} of module global '{guard.name}' (guarded-by "
                    f"'{guard.lock}') in {fn.name}() is not inside "
                    f"'with {guard.lock}:'"))
        return out

    @staticmethod
    def _enclosing_function(node: ast.AST) -> Optional[ast.AST]:
        cur = getattr(node, "parent", None)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = getattr(cur, "parent", None)
        return None

    # -- lock-acquisition graph ---------------------------------------------

    def lock_graph(self) -> dict:
        """``{"locks": {id: ctor}, "edges": [LockSite...],
        "cycles": [[lock ids]], "self_deadlocks": [LockSite...]}``."""
        if self._graph_cache is not None:
            return self._graph_cache
        builder = _GraphBuilder(self)
        self._graph_cache = builder.build()
        return self._graph_cache

    def lock_graph_json(self) -> dict:
        """The --graph artifact: JSON-serializable acquisition graph."""
        g = self.lock_graph()
        edges: Dict[Tuple[str, str], dict] = {}
        for site in g["edges"]:
            rec = edges.setdefault((site.held, site.taken), {
                "held": site.held, "taken": site.taken, "count": 0,
                "example": f"{site.rel}:{site.line}"})
            rec["count"] += 1
        return {
            "locks": [{"id": k, "type": v}
                      for k, v in sorted(g["locks"].items())],
            "edges": sorted(edges.values(),
                            key=lambda e: (e["held"], e["taken"])),
            "cycles": g["cycles"],
            "self_deadlocks": [
                {"lock": s.taken, "site": f"{s.rel}:{s.line}"}
                for s in g["self_deadlocks"]],
        }

    # -- faultpoints ---------------------------------------------------------

    def faultpoint_sites(self) -> List[tuple]:
        """``(rel, line, site_or_pattern, is_pattern)`` for every
        ``faultpoint(...)`` call in non-test files (cached). A Name
        argument resolves through a single local assignment in the
        enclosing function — the dynamic-site idiom
        ``site = f"distributed.{algo}.{phase}.shard"``. A site handed to a
        module-level helper that calls ``faultpoint(param)`` on one of its
        parameters counts at the call: ``_filter_plan("ivf_pq.search.filter",
        ...)`` declares ``ivf_pq.search.filter`` (the helper is found in the
        same module or through the caller's import table)."""
        if self._faultpoints is not None:
            return self._faultpoints
        helpers = self._faultpoint_helpers()
        out = []
        for rel, ctx in self.contexts.items():
            if _is_test_rel(rel):
                continue
            for node in walk(ctx.tree):
                if not isinstance(node, ast.Call):
                    continue
                name = _call_name(node.func)
                if not name:
                    continue
                arg = None
                if name[-1] == "faultpoint" and node.args:
                    arg = node.args[0]
                    if isinstance(arg, ast.Name):
                        arg = _local_str_binding(arg)
                else:
                    key = self._function_key(ctx, name)
                    if key in helpers:
                        arg = _argument(node, *helpers[key])
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    out.append((rel, node.lineno, arg.value, False))
                elif isinstance(arg, ast.JoinedStr):
                    out.append((rel, node.lineno,
                                _joined_to_regex(arg), True))
        self._faultpoints = out
        return out

    def _faultpoint_helpers(self) -> Dict[str, Tuple[int, str]]:
        """``rel::fn`` -> (position, name) of the parameter a module-level
        function passes to ``faultpoint`` unchanged."""
        out: Dict[str, Tuple[int, str]] = {}
        for rel, ctx in self.contexts.items():
            if _is_test_rel(rel):
                continue
            for stmt in ctx.tree.body:
                if not isinstance(stmt, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                params = [a.arg for a in stmt.args.posonlyargs
                          + stmt.args.args]
                for node in walk(stmt):
                    if isinstance(node, ast.Call) and node.args and \
                            (_call_name(node.func) or ("",))[-1] == \
                            "faultpoint" and \
                            isinstance(node.args[0], ast.Name) and \
                            node.args[0].id in params:
                        pname = node.args[0].id
                        out[f"{rel}::{stmt.name}"] = (params.index(pname),
                                                      pname)
                        break
        return out

    def _function_key(self, ctx, name: Tuple[str, ...]) -> Optional[str]:
        """``rel::fn`` of a called module-level function: a bare name in
        this module or from-imported, or ``module.fn`` through an
        import."""
        if len(name) == 1:
            origin = ctx.imports.get(name[0])
            if origin and "." in origin:
                mod, fn = origin.rsplit(".", 1)
                rel = self.rel_for_module(mod)
                return f"{rel}::{fn}" if rel else None
            return f"{ctx.rel}::{name[0]}"
        if len(name) == 2:
            origin = ctx.imports.get(name[0])
            rel = self.rel_for_module(origin) if origin else None
            return f"{rel}::{name[1]}" if rel else None
        return None

    def arming_sites(self) -> List[tuple]:
        """``(rel, line, site_or_pattern, is_pattern)`` for every string in
        test files that parses as a valid RAFT_TPU_FAULTS spec, excluding
        strings inside ``@pytest.mark.slow`` functions/classes (those never
        run in tier-1, so they prove nothing). An f-string whose fault kind
        is a hole (``f"tuning.autotune.window={fault}:1"``, the
        parametrised-kind idiom) arms the site before its ``=``."""
        if self._armings is not None:
            return self._armings
        out = []
        for rel, ctx in self.contexts.items():
            if not _is_test_rel(rel):
                continue
            for node in walk(ctx.tree):
                spec = None
                pattern = False
                if isinstance(node, ast.Constant) and isinstance(node.value, str):
                    spec = node.value
                elif isinstance(node, ast.JoinedStr):
                    raw = _joined_to_sample(node)
                    if _ARM_RE.match(raw.replace("\x00", "x")):
                        spec = _joined_to_regex(node)
                        pattern = True
                    elif _ARM_RE.match(raw.replace("\x00", _FAULT_KINDS[0])):
                        site = _joined_site(node)
                        if site is not None and not _in_slow_marked(node):
                            out.append((rel, node.lineno, *site))
                        continue
                if spec is None:
                    continue
                if not pattern and not _ARM_RE.match(spec):
                    continue
                if _in_slow_marked(node):
                    continue
                site = re.sub(
                    r"=(" + "|".join(_FAULT_KINDS) + r")(:.*)?$", "", spec)
                out.append((rel, node.lineno, site, pattern))
        self._armings = out
        return out

    # -- env knobs -----------------------------------------------------------

    def knob_reads(self) -> List[tuple]:
        """``(rel, line, knob, has_default)`` for every environ read of a
        ``RAFT_TPU_*`` name in non-test files, resolving module-level
        ``*_ENV`` string constants (cached)."""
        if self._knob_cache is not None:
            return self._knob_cache
        out = []
        for rel, ctx in self.contexts.items():
            if _is_test_rel(rel):
                continue
            consts = _env_constants(ctx)
            for node in walk(ctx.tree):
                hit = _environ_read(node, consts)
                if hit:
                    out.append((rel, node.lineno, hit[0], hit[1]))
        self._knob_cache = out
        return out


# ---------------------------------------------------------------------------
# lock graph construction
# ---------------------------------------------------------------------------

class _GraphBuilder:
    """Two passes: per-function acquisition summaries (fixed point over the
    call graph), then a flow walk of every function recording which locks
    are held at each acquisition."""

    def __init__(self, project: ProjectContext) -> None:
        self.p = project
        self.locks: Dict[str, str] = {}
        self.edges: List[LockSite] = []
        self.self_deadlocks: List[LockSite] = []
        # function key -> (ctx, node, owner ClassInfo or None)
        self.functions: Dict[str, tuple] = {}
        self.summaries: Dict[str, Set[str]] = {}
        self._index_functions()

    def _index_functions(self) -> None:
        for info in self.p.classes.values():
            for name, meth in info.methods.items():
                self.functions[f"{info.key}.{name}"] = (
                    self.p.contexts[info.rel], meth, info)
            for attr, ctor in info.locks.items():
                self.locks[f"{info.key}.{attr}"] = ctor
        for rel, ctx in self.p.contexts.items():
            for stmt in ctx.tree.body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.functions[f"{rel}::{stmt.name}"] = (ctx, stmt, None)
            for name, ctor in self.p.module_locks.get(rel, {}).items():
                self.locks[f"{rel}::{name}"] = ctor

    # -- resolution ----------------------------------------------------------

    def _lock_id(self, expr, info) -> Optional[str]:
        """A with-item / acquire receiver -> lock id, when it names a known
        lock (self attr of the owning class, or module-level lock)."""
        if _is_self_attr(expr) and info is not None \
                and expr.attr in info.locks:
            return f"{info.key}.{expr.attr}"
        if isinstance(expr, ast.Name):
            rel = self._cur_rel
            if expr.id in self.p.module_locks.get(rel, {}):
                return f"{rel}::{expr.id}"
        return None

    def _callee_keys(self, call: ast.Call, ctx, info) -> List[str]:
        name = _call_name(call.func)
        if name is None:
            return []
        out = []
        if len(name) == 2 and name[0] == "self" and info is not None:
            key = f"{info.key}.{name[1]}"
            if key in self.functions:
                out.append(key)
        elif len(name) == 3 and name[0] == "self" and info is not None:
            tkey = info.attr_types.get(name[1])
            if tkey:
                key = f"{tkey}.{name[2]}"
                if key in self.functions:
                    out.append(key)
        elif len(name) == 1:
            key = f"{ctx.rel}::{name[0]}"
            if key in self.functions:
                out.append(key)
            else:
                origin = ctx.imports.get(name[0])
                if origin and "." in origin:
                    mod, fn = origin.rsplit(".", 1)
                    rel = self.p.rel_for_module(mod)
                    if rel:
                        key = f"{rel}::{fn}"
                        if key in self.functions:
                            out.append(key)
        elif len(name) == 2:
            origin = ctx.imports.get(name[0])
            if origin:
                rel = self.p.rel_for_module(origin)
                if rel:
                    key = f"{rel}::{name[1]}"
                    if key in self.functions:
                        out.append(key)
        return out

    # -- pass 1: summaries ---------------------------------------------------

    def _direct_acquires(self, fkey: str) -> Tuple[Set[str], List[str]]:
        ctx, node, info = self.functions[fkey]
        self._cur_rel = ctx.rel
        acquired: Set[str] = set()
        callees: List[str] = []
        for sub in walk(node):
            if isinstance(sub, ast.With):
                for item in sub.items:
                    lid = self._lock_id(item.context_expr, info)
                    if lid:
                        acquired.add(lid)
            elif isinstance(sub, ast.Call):
                if isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr == "acquire":
                    lid = self._lock_id(sub.func.value, info)
                    if lid:
                        acquired.add(lid)
                callees.extend(self._callee_keys(sub, ctx, info))
        return acquired, callees

    def _compute_summaries(self) -> None:
        direct: Dict[str, Set[str]] = {}
        calls: Dict[str, List[str]] = {}
        for fkey in self.functions:
            d, c = self._direct_acquires(fkey)
            direct[fkey] = d
            calls[fkey] = c
        summaries = {k: set(v) for k, v in direct.items()}
        changed = True
        while changed:
            changed = False
            for fkey, callees in calls.items():
                s = summaries[fkey]
                before = len(s)
                for c in callees:
                    s |= summaries.get(c, set())
                if len(s) != before:
                    changed = True
        self.summaries = summaries

    # -- pass 2: edges ---------------------------------------------------------

    def _walk(self, node, held: Tuple[str, ...], ctx, info) -> None:
        if isinstance(node, ast.With):
            taken: List[str] = []
            for item in node.items:
                lid = self._lock_id(item.context_expr, info)
                if lid:
                    self._record(held, lid, ctx, node.lineno)
                    taken.append(lid)
            inner = held + tuple(t for t in taken if t not in held)
            for child in node.body:
                self._walk(child, inner, ctx, info)
            return
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "acquire":
                lid = self._lock_id(node.func.value, info)
                if lid:
                    self._record(held, lid, ctx, node.lineno)
            if held:
                for ckey in self._callee_keys(node, ctx, info):
                    for lid in self.summaries.get(ckey, ()):
                        self._record(held, lid, ctx, node.lineno)
        for child in ast.iter_child_nodes(node):
            self._walk(child, held, ctx, info)

    def _record(self, held: Tuple[str, ...], taken: str, ctx,
                line: int) -> None:
        for h in held:
            if h == taken:
                if not _LOCK_CTORS.get(self.locks.get(taken, "Lock"), False):
                    self.self_deadlocks.append(
                        LockSite(h, taken, ctx.rel, line))
                continue
            self.edges.append(LockSite(h, taken, ctx.rel, line))

    # -- cycles ----------------------------------------------------------------

    @staticmethod
    def _cycles(nodes: Set[str], edges: List[LockSite]) -> List[List[str]]:
        adj: Dict[str, Set[str]] = {n: set() for n in nodes}
        for e in edges:
            adj.setdefault(e.held, set()).add(e.taken)
            adj.setdefault(e.taken, set())
        # Tarjan SCC, iterative
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on: Set[str] = set()
        stack: List[str] = []
        out: List[List[str]] = []
        counter = [0]

        def strongconnect(v: str) -> None:
            work = [(v, iter(sorted(adj[v])))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on.add(w)
                        work.append((w, iter(sorted(adj[w]))))
                        advanced = True
                        break
                    if w in on:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    scc = []
                    while True:
                        w = stack.pop()
                        on.discard(w)
                        scc.append(w)
                        if w == node:
                            break
                    if len(scc) > 1:
                        out.append(sorted(scc))

        for n in sorted(adj):
            if n not in index:
                strongconnect(n)
        return out

    def build(self) -> dict:
        self._compute_summaries()
        for fkey, (ctx, node, info) in self.functions.items():
            self._cur_rel = ctx.rel
            for child in ast.iter_child_nodes(node):
                self._walk(child, (), ctx, info)
        nodes = set(self.locks)
        for e in self.edges:
            nodes.add(e.held)
            nodes.add(e.taken)
        return {
            "locks": dict(self.locks),
            "edges": self.edges,
            "cycles": self._cycles(nodes, self.edges),
            "self_deadlocks": self.self_deadlocks,
        }


# ---------------------------------------------------------------------------
# shared helpers for the contract rules
# ---------------------------------------------------------------------------

def _local_str_binding(name: ast.Name) -> Optional[ast.AST]:
    """Resolve a Name to the value of a single local assignment in the
    enclosing function: ``site = f"..."; faultpoint(site)``. Returns the
    value node when exactly one assignment binds the name, else None."""
    fn = ProjectContext._enclosing_function(name)
    if fn is None:
        return None
    bindings = []
    for sub in walk(fn):
        if isinstance(sub, ast.Assign):
            for t in sub.targets:
                if isinstance(t, ast.Name) and t.id == name.id:
                    bindings.append(sub.value)
    return bindings[0] if len(bindings) == 1 else None


def _is_test_rel(rel: str) -> bool:
    parts = rel.split("/")
    return parts[0] == "tests" or parts[-1].startswith("test_") \
        or parts[-1].startswith("conftest")


_HOLE = r"[\w\-]+"


def _joined_to_regex(node: ast.JoinedStr) -> str:
    parts = []
    for v in node.values:
        if isinstance(v, ast.Constant):
            parts.append(re.escape(str(v.value)))
        else:
            parts.append(_HOLE)
    return "".join(parts)


def _joined_site(node: ast.JoinedStr) -> Optional[Tuple[str, bool]]:
    """The site part (before the first ``=``) of an arming f-string, as
    ``(site, False)`` when it has no holes, else ``(regex, True)``."""
    parts, holes = [], False
    for v in node.values:
        if isinstance(v, ast.Constant):
            text = str(v.value)
            if "=" in text:
                parts.append(re.escape(text.split("=", 1)[0]))
                site = "".join(parts)
                return (site, True) if holes else (
                    site.replace("\\", ""), False)
            parts.append(re.escape(text))
        else:
            parts.append(_HOLE)
            holes = True
    return None


def _argument(call: ast.Call, position: int, name: str) -> Optional[ast.AST]:
    """The argument a call passes for the parameter at ``position`` named
    ``name``."""
    if position < len(call.args):
        return call.args[position]
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _joined_to_sample(node: ast.JoinedStr) -> str:
    parts = []
    for v in node.values:
        if isinstance(v, ast.Constant):
            parts.append(str(v.value))
        else:
            parts.append("\x00")
    return "".join(parts)


def sites_compatible(a: str, a_pat: bool, b: str, b_pat: bool) -> bool:
    """Whether faultpoint site ``a`` and arming site ``b`` can denote the
    same runtime site (either may be a regex pattern from an f-string)."""
    if not a_pat and not b_pat:
        return a == b
    if a_pat and not b_pat:
        return re.fullmatch(a, b) is not None
    if b_pat and not a_pat:
        return re.fullmatch(b, a) is not None
    sample_a = a.replace(_HOLE, "x").replace("\\", "")
    sample_b = b.replace(_HOLE, "x").replace("\\", "")
    return (re.fullmatch(a, sample_b) is not None
            or re.fullmatch(b, sample_a) is not None)


def _in_slow_marked(node: ast.AST) -> bool:
    cur = getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            for dec in cur.decorator_list:
                name = _call_name(dec if not isinstance(dec, ast.Call)
                                  else dec.func)
                if name and "slow" in name and "mark" in name:
                    return True
        cur = getattr(cur, "parent", None)
    return False


def _env_constants(ctx) -> Dict[str, str]:
    """Module-level ``X_ENV = "RAFT_TPU_..."`` constants."""
    out: Dict[str, str] = {}
    for stmt in ctx.tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and isinstance(stmt.value, ast.Constant) \
                and isinstance(stmt.value.value, str) \
                and stmt.value.value.startswith(_KNOB_PREFIX):
            out[stmt.targets[0].id] = stmt.value.value
    return out


def _environ_read(node: ast.AST, consts: Dict[str, str]) -> Optional[tuple]:
    """``(knob, has_default)`` when ``node`` reads a RAFT_TPU_* env var:
    ``os.environ.get(K[, d])``, ``os.environ[K]``, ``os.getenv(K[, d])``."""

    def knob_of(arg) -> Optional[str]:
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                and arg.value.startswith(_KNOB_PREFIX):
            return arg.value
        if isinstance(arg, ast.Name) and arg.id in consts:
            return consts[arg.id]
        return None

    if isinstance(node, ast.Call):
        name = _call_name(node.func)
        if name and node.args:
            if name[-2:] in (("environ", "get"),) or name[-1] == "getenv":
                k = knob_of(node.args[0])
                if k:
                    return k, len(node.args) > 1
            # per-module default helpers: _env_float(NAME_ENV, 0.5) and kin
            # supply a default for the knob exactly like a 2-arg get
            if name[-1].startswith(("_env_", "default_")):
                k = knob_of(node.args[0])
                if k:
                    return k, True
    elif isinstance(node, ast.Subscript) \
            and isinstance(node.ctx, ast.Load) \
            and isinstance(node.value, ast.Attribute) \
            and node.value.attr == "environ":
        k = knob_of(node.slice)
        if k:
            return k, False
    return None
