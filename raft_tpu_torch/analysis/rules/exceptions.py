"""swallowed-exception: bare ``except:`` and silent broad handlers
(counterpart of ``raft_tpu/analysis/rules/exceptions.py``).

A bare ``except:`` catches ``KeyboardInterrupt``/``SystemExit`` — that
turns a Ctrl-C or watchdog kill into a hang. A broad
``except Exception: pass`` around device calls is subtler: CUDA errors
(OOM, a failed launch, an illegal address) vanish and the caller proceeds
on garbage. Narrow handlers that swallow deliberately
(``except AttributeError: pass`` on frozen-dataclass cache writes) are the
documented idiom here and stay legal.
"""

from __future__ import annotations

import ast

from raft_tpu_torch.analysis.jit_regions import walk
from raft_tpu_torch.analysis.registry import Rule, register
from raft_tpu_torch.analysis.rules._common import resolve_call

_BROAD = {"Exception", "BaseException"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = t.elts if isinstance(t, ast.Tuple) else [t]
    return any(isinstance(n, ast.Name) and n.id in _BROAD for n in names)


def _swallows(handler: ast.ExceptHandler) -> bool:
    return all(
        isinstance(s, (ast.Pass, ast.Continue)) or
        (isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant))
        for s in handler.body)


def _try_touches_device(ctx, try_node: ast.Try) -> bool:
    for stmt in try_node.body:
        for node in walk(stmt):
            if isinstance(node, ast.Call):
                resolved = resolve_call(ctx, node.func)
                if resolved.startswith("torch."):
                    return True
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr in ("synchronize", "cuda"):
                    return True
    return False


@register
class SwallowedExceptionRule(Rule):
    id = "swallowed-exception"
    severity = "error"
    description = ("bare except, or broad except that silently swallows "
                   "(fatal around device calls)")

    def check(self, ctx):
        for node in walk(ctx.tree):
            if not isinstance(node, ast.Try):
                continue
            for handler in node.handlers:
                if handler.type is None:
                    yield self.finding(
                        ctx, handler,
                        "bare `except:` also catches KeyboardInterrupt/"
                        "SystemExit — name the exception(s)")
                elif _is_broad(handler) and _swallows(handler):
                    where = (" around device calls"
                             if _try_touches_device(ctx, node) else "")
                    yield self.finding(
                        ctx, handler,
                        f"broad except silently swallows{where} — narrow "
                        f"the type or at least log it",
                        severity="error" if where else "warning")
