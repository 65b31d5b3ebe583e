"""guarded-state: lock-discipline enforcement for annotated shared fields
(counterpart of ``raft_tpu/analysis/rules/guarded_state.py``).

Classes (and modules) declare which lock protects a field with a comment on
the line that first assigns it::

    self._pending = deque()   # guarded-by: _cv
    self._window = 0          # guarded-by: _lock, reads-ok
    _SPANS = deque()          # guarded-by: _LOCK     (module global)

The rule then resolves **every** read and write of that field across the
class's methods (including nested functions and lambdas) and flags any
access not dominated by a ``with self._lock:`` scope. Escape hatches, in
order of preference:

* ``reads-ok`` — unlocked reads tolerated (snapshot-then-release folds like
  the paged store's ``_live_rows``, monotonic counters read for display);
* lock-held-on-entry methods — construction methods, ``*_locked`` names,
  ``# holds: _lock`` declarations on the ``def`` line, and any method whose
  intra-class self-call sites are all themselves dominated (fixed point);
* ``# graftlint: ignore[guarded-state]`` for the truly deliberate.

The heavy lifting (class table, dominance, fixed point) lives in
:mod:`raft_tpu_torch.analysis.projectgraph`; results are computed once per scan
and emitted per file here.
"""

from __future__ import annotations

from raft_tpu_torch.analysis.registry import Rule, register


@register
class GuardedStateRule(Rule):
    id = "guarded-state"
    severity = "error"
    description = ("access to a '# guarded-by:' annotated field outside its "
                   "lock (and not in a lock-held-on-entry method)")

    def check(self, ctx):
        if ctx.project is None:
            return
        for rel, line, message in ctx.project.guarded_state_results():
            if rel == ctx.rel:
                node = _Anchor(line)
                yield self.finding(ctx, node, message)


class _Anchor:
    """Minimal lineno carrier for Rule.finding."""

    def __init__(self, lineno: int) -> None:
        self.lineno = lineno
