"""recompile-hazard: patterns that silently recompile or read a tensor back
(counterpart of ``raft_tpu/analysis/rules/recompile.py``).

Two decidable shapes:

* a graph compiler or kernel build constructed inside a loop —
  ``torch.compile(...)``, ``torch.jit.script/trace(...)``,
  ``torch.utils.cpp_extension.load/load_inline(...)`` or
  ``_native.build()`` in a ``for``/``while`` body. Each iteration builds a
  fresh wrapper with an empty cache (or re-runs the compiler), so every
  call recompiles. Hoist it to module level or cache the wrapper.
* an f-string formatting a tensor value inside a launch region or a loop
  of a ``@traced`` entry point — on CUDA ``Tensor.__format__`` copies the
  value to the host and waits for the card, once per formatted string.
  Shape/dtype/device interpolation reads metadata and is exempt.

(JAX's third shape, a static argument rebound as an array, has no torch
counterpart: eager torch has no static arguments.)
"""

from __future__ import annotations

import ast

from raft_tpu_torch.analysis.jit_regions import walk
from raft_tpu_torch.analysis.registry import Rule, register
from raft_tpu_torch.analysis.rules._common import (
    enclosing_loop,
    expr_is_tensor,
    function_taint,
    in_traced_loop,
    resolve_call,
)

_BUILDERS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
             "torch.utils.cpp_extension.load",
             "torch.utils.cpp_extension.load_inline"}


def _is_builder(ctx, call: ast.Call) -> str:
    resolved = resolve_call(ctx, call.func)
    if resolved in _BUILDERS:
        return resolved
    mod, _, tail = resolved.rpartition(".")
    if tail == "build" and mod.rsplit(".", 1)[-1] == "_native":
        return "_native.build"
    return ""


@register
class RecompileHazardRule(Rule):
    id = "recompile-hazard"
    severity = "warning"
    description = ("torch.compile/jit/kernel build inside a loop, or an "
                   "f-string formatting a tensor on the launch path")

    def check(self, ctx):
        for node in walk(ctx.tree):
            if isinstance(node, ast.Call):
                built = _is_builder(ctx, node)
                if built and enclosing_loop(node) is not None:
                    yield self.finding(
                        ctx, node,
                        f"{built}(...) constructed inside a loop starts with "
                        f"an empty cache every iteration — hoist it")

            elif isinstance(node, ast.JoinedStr) and (
                    ctx.regions.in_region(node)
                    or in_traced_loop(ctx, node)):
                taint = function_taint(ctx, node)
                for val in node.values:
                    if isinstance(val, ast.FormattedValue) and \
                            expr_is_tensor(ctx, val.value, taint):
                        yield self.finding(
                            ctx, node,
                            "f-string formats a tensor on the launch path — "
                            "on CUDA that copies it to the host and waits "
                            "for the card; interpolate shapes/dtypes or "
                            "move it to host code")
                        break
