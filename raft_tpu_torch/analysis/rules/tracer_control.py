"""tensor-branch: Python control flow on a tensor where the card should run
on (counterpart of ``raft_tpu/analysis/rules/tracer_control.py``, whose
``tracer-branch`` flags control flow on traced values).

``if mask.any():`` on a CUDA tensor is an implicit ``.item()``: Python asks
the tensor for its truth, torch copies one element to the host and the
host waits for every kernel queued before it. Inside a launch region (see
:mod:`raft_tpu_torch.analysis.jit_regions`) that idles the card between
launches; in a loop of a ``@traced`` entry point it does so every
iteration. The fix is ``torch.where`` / masking, or one host read hoisted
out of the loop. The rule flags ``if`` / ``while`` / ``assert`` tests and
explicit ``bool(...)`` on tensor-valued expressions there — host code
branching on a materialized result is fine, as are ``x is None`` probes,
``len()``/``isinstance()`` and ``.shape``/``.dtype``/``.device`` reads.
"""

from __future__ import annotations

import ast

from raft_tpu_torch.analysis.jit_regions import walk
from raft_tpu_torch.analysis.registry import Rule, register
from raft_tpu_torch.analysis.rules._common import (
    expr_is_tensor,
    function_taint,
    in_traced_loop,
    under_obs_gate,
)


def _test_is_tensor(ctx, node: ast.AST, taint) -> bool:
    """Does this test read a tensor's truth? Recursive so that statically
    decidable subtrees are pruned: ``x is None`` probes structure, and
    ``and``/``or``/``not`` only combine their operands' truths."""
    if isinstance(node, ast.Compare) and \
            all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
        return False
    if isinstance(node, ast.BoolOp):
        return any(_test_is_tensor(ctx, v, taint) for v in node.values)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        return _test_is_tensor(ctx, node.operand, taint)
    return expr_is_tensor(ctx, node, taint)


@register
class TensorBranchRule(Rule):
    id = "tensor-branch"
    severity = "error"
    description = ("Python if/while/assert/bool() on a tensor inside a "
                   "launch region or a @traced loop (an implicit .item())")

    def check(self, ctx):
        for node in walk(ctx.tree):
            if isinstance(node, (ast.If, ast.While, ast.Assert)):
                test = node.test
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id == "bool" and len(node.args) == 1:
                test = node.args[0]
            else:
                continue
            if not (ctx.regions.in_region(node)
                    or in_traced_loop(ctx, node)):
                continue
            if under_obs_gate(ctx, node):
                continue
            if _test_is_tensor(ctx, test, function_taint(ctx, node)):
                kind = "bool()" if isinstance(node, ast.Call) else \
                    type(node).__name__.lower()
                yield self.finding(
                    ctx, node,
                    f"Python `{kind}` on a tensor where the card should run "
                    f"on — an implicit .item() that waits for every queued "
                    f"kernel; use torch.where/masking or hoist one host "
                    f"read out of the loop")
