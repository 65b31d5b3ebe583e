"""Pluggable rule registry.

A rule is a class with ``id``/``severity``/``description`` and a
``check(ctx)`` generator yielding :class:`~raft_tpu_torch.analysis.findings.Finding`
objects for one parsed module. Decorating it with :func:`register` puts an
instance in the process-wide catalog; the walker runs every registered rule
over every collected file (rules scope themselves by path — see e.g.
``banned-api``, which only looks at kernel/ops modules).

Third parties (scripts, tests) can register extra rules before calling
``analyze_paths`` — the registry is deliberately just a dict.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, TYPE_CHECKING

if TYPE_CHECKING:  # import cycle: walker imports registry
    from raft_tpu_torch.analysis.findings import Finding
    from raft_tpu_torch.analysis.walker import ModuleContext


class Rule:
    """Base class; subclasses set the three class attrs and yield findings."""

    id: str = ""
    severity: str = "warning"
    description: str = ""

    def check(self, ctx: "ModuleContext") -> "Iterator[Finding]":
        raise NotImplementedError

    def finding(self, ctx: "ModuleContext", node, message: str,
                severity: str = "") -> "Finding":
        """Build a Finding anchored at ``node`` (any ast node with lineno)."""
        from raft_tpu_torch.analysis.findings import Finding

        line = getattr(node, "lineno", 0)
        return Finding(
            path=ctx.rel,
            line=line,
            rule=self.id,
            severity=severity or self.severity,
            message=message,
            snippet=ctx.snippet(line),
        )


_RULES: Dict[str, Rule] = {}


def register(cls):
    """Class decorator: instantiate and add to the catalog (id must be set
    and unique — a duplicate id is a programming error, fail loudly)."""
    inst = cls()
    if not inst.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if inst.id in _RULES:
        raise ValueError(f"duplicate rule id {inst.id!r}")
    _RULES[inst.id] = inst
    return cls


def all_rules() -> List[Rule]:
    """Every registered rule, id-sorted (ensures rule modules are loaded)."""
    import raft_tpu_torch.analysis.rules  # noqa: F401  (registration side effect)

    return [_RULES[k] for k in sorted(_RULES)]


def get_rule(rule_id: str) -> Rule:
    import raft_tpu_torch.analysis.rules  # noqa: F401

    return _RULES[rule_id]


def resolve(selection: Iterable[str]) -> List[Rule]:
    """Map ids to rules, unknown id -> KeyError with the catalog listed."""
    rules = []
    for rid in selection:
        try:
            rules.append(get_rule(rid))
        except KeyError:
            known = ", ".join(sorted(_RULES))
            raise KeyError(f"unknown rule {rid!r}; known: {known}") from None
    return rules
