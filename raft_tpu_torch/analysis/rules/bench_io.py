"""bench-io: bench results writes must go through a crash-safe channel
(counterpart of ``raft_tpu/analysis/rules/bench_io.py``).

Any bench result that lives only in process memory — or in a file written
without flush+fsync — is lost the moment a watchdog kills the run. ``bench/progress.py`` is the
crash-safe channel for results (append, flush, fsync per record,
salvageable after a kill) and
``core/fsio.atomic_write`` for whole-file artifacts. Direct
write-mode ``open()`` / ``np.save*`` / ``.tofile()`` / ``Path.write_text``
in bench code bypasses both guarantees, so it gets flagged; writes INSIDE
a ``with atomic_write(...)`` block, ``progress.py`` itself and read-mode
opens are exempt. Legitimate non-results writes (dataset caches,
user-pointed ``--output``) are baselined with justifications rather than
silently allowed.
"""

from __future__ import annotations

import ast

from raft_tpu_torch.analysis.jit_regions import walk
from raft_tpu_torch.analysis.registry import Rule, register
from raft_tpu_torch.analysis.rules._common import resolve_call

_WRITE_MODES = set("wax")
_NP_WRITERS = {"numpy.save", "numpy.savez", "numpy.savez_compressed",
               "numpy.savetxt"}
_PATH_WRITERS = {"write_text", "write_bytes"}
_ARRAY_WRITERS = {"tofile"}
#: context managers that ARE the crash-safe channel — everything written
#: inside their ``with`` block is sanctioned
_SAFE_CTX = {"atomic_write"}


def _sanctioned_nodes(tree) -> set:
    """ids of Call nodes that write THROUGH an atomic stream: inside a
    ``with atomic_write(...) as f`` block, only calls that take ``f`` as
    receiver or argument (``f.write(...)``, ``arr.tofile(f)``,
    ``np.save(f, ...)``) are sanctioned — an unrelated ``open(b, "wb")``
    nested in the same block stays flagged."""
    out: set = set()
    for w in walk(tree):
        if not isinstance(w, (ast.With, ast.AsyncWith)):
            continue
        aliases = set()
        for item in w.items:
            c = item.context_expr
            if isinstance(c, ast.Call) and isinstance(
                    c.func, (ast.Name, ast.Attribute)):
                name = (c.func.id if isinstance(c.func, ast.Name)
                        else c.func.attr)
                if name in _SAFE_CTX and isinstance(
                        item.optional_vars, ast.Name):
                    aliases.add(item.optional_vars.id)
        if not aliases:
            continue
        for node in walk(w):
            if not isinstance(node, ast.Call):
                continue
            args = list(node.args) + [kw.value for kw in node.keywords]
            uses = any(isinstance(a, ast.Name) and a.id in aliases
                       for a in args)
            if isinstance(node.func, ast.Attribute) and isinstance(
                    node.func.value, ast.Name) and \
                    node.func.value.id in aliases:
                uses = True
            if uses:
                out.add(id(node))
    return out


def _open_mode(node: ast.Call) -> str:
    if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant) and \
            isinstance(node.args[1].value, str):
        return node.args[1].value
    for kw in node.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant) and \
                isinstance(kw.value.value, str):
            return kw.value.value
    return "r"


@register
class BenchIoRule(Rule):
    id = "bench-io"
    severity = "warning"
    description = ("bench code writing files directly instead of through "
                   "the crash-safe bench/progress.py channel")

    def check(self, ctx):
        in_scope = ctx.rel == "bench.py" or (
            "bench" in ctx.rel.split("/")[:-1])
        if not in_scope or ctx.rel.endswith("/progress.py"):
            return
        sanctioned = _sanctioned_nodes(ctx.tree)
        for node in walk(ctx.tree):
            if not isinstance(node, ast.Call) or id(node) in sanctioned:
                continue
            label = ""
            if isinstance(node.func, ast.Name) and node.func.id == "open":
                if _WRITE_MODES.intersection(_open_mode(node)):
                    label = f"open(…, {_open_mode(node)!r})"
            elif resolve_call(ctx, node.func) in _NP_WRITERS:
                label = resolve_call(ctx, node.func)
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _PATH_WRITERS | _ARRAY_WRITERS:
                label = f".{node.func.attr}()"
            if label:
                yield self.finding(
                    ctx, node,
                    f"direct {label} in bench code — route results through "
                    f"bench/progress.py or core/fsio.atomic_write (fsync'd, "
                    f"crash-safe) so a killed run keeps its artifacts")
