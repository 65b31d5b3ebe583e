"""launch-host-sync + loop-host-transfer: the host waiting for the card
(counterpart of ``raft_tpu/analysis/rules/host_sync.py``).

Two rules share this module because they share the sync predicate
(:func:`~raft_tpu_torch.analysis.rules._common.sync_kind`: ``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()``, ``int()``/``float()``/``bool()``
of a tensor, ``torch.nonzero``, boolean-mask indexing,
``torch.cuda.synchronize()`` and kin):

* ``launch-host-sync`` — JAX's ``jit-host-sync``, recast: a torch sync
  INSIDE a launch region (a function that launches a hand kernel through
  ``ops/_native``, one handed to ``torch.compile`` / ``torch.jit``, a CUDA
  graph capture, and their same-module callees). There the host waits for
  every launch queued before it, so the card idles between kernels that
  should run back to back (and a capture fails outright).

* ``loop-host-transfer`` — the same syncs inside ``for``/``while`` loops
  (and comprehensions) of ``@traced`` HOST entry points (build/search
  drivers). One sync per iteration serializes the launch pipeline.
  Syncs gated behind ``if obs.enabled():`` (or in a helper that no-ops
  when telemetry is off) are exempt — the telemetry-off fast path.
"""

from __future__ import annotations

import ast

from raft_tpu_torch.analysis.jit_regions import walk
from raft_tpu_torch.analysis.registry import Rule, register
from raft_tpu_torch.analysis.rules._common import (
    enclosing_loop,
    function_taint,
    has_obs_early_return,
    is_traced_decorated,
    iter_functions,
    sync_kind,
    taint_for_function,
    under_obs_gate,
)


def _sync_nodes(tree):
    return (node for node in walk(tree)
            if isinstance(node, (ast.Call, ast.Subscript)))


@register
class LaunchHostSyncRule(Rule):
    id = "launch-host-sync"
    severity = "error"
    description = ("torch host sync (.item/.cpu/int(t)/nonzero/t[mask]/"
                   "synchronize) inside a kernel-launch or compiled region")

    def check(self, ctx):
        for node in _sync_nodes(ctx.tree):
            if not ctx.regions.in_region(node):
                continue
            kind = sync_kind(ctx, node, function_taint(ctx, node))
            if kind:
                yield self.finding(
                    ctx, node,
                    f"{kind} inside a launch region makes the host wait for "
                    f"every queued kernel, so the card idles before the next "
                    f"launch; keep the value on the card or hoist the read "
                    f"out of the launch path")


def _syncing_locals(ctx) -> set:
    """Names of module-local functions that sync un-gated (one level
    deep — catches helpers like a probe's ``_sync``)."""
    out = set()
    for fn in iter_functions(ctx.tree):
        if has_obs_early_return(ctx, fn):
            continue
        taint = taint_for_function(ctx, fn)
        for node in _sync_nodes(fn):
            if sync_kind(ctx, node, taint) and not under_obs_gate(ctx, node):
                out.add(fn.name)
                break
    return out


@register
class LoopHostTransferRule(Rule):
    id = "loop-host-transfer"
    severity = "warning"
    description = ("device→host sync inside a loop of a @traced entry "
                   "point (gate it behind obs.enabled() or hoist it)")

    def check(self, ctx):
        syncing = None  # computed lazily: most files have no @traced fns
        for fn in iter_functions(ctx.tree):
            if not is_traced_decorated(fn):
                continue
            for node in _sync_nodes(fn):
                loop = enclosing_loop(node)
                if loop is None or not any(
                        f is fn for f in ctx.regions.enclosing_functions(loop)):
                    continue
                kind = sync_kind(ctx, node, function_taint(ctx, node))
                if not kind and isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Name):
                    if syncing is None:
                        syncing = _syncing_locals(ctx)
                    if node.func.id in syncing:
                        kind = f"{node.func.id}() [syncs internally]"
                if kind and not under_obs_gate(ctx, node):
                    yield self.finding(
                        ctx, node,
                        f"{kind} in a loop of @traced `{fn.name}` makes the "
                        f"host wait for the card every iteration; hoist it "
                        f"or gate it behind obs.enabled()")
