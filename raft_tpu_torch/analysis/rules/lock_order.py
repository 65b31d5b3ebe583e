"""lock-order: deadlock cycles in the repo-wide lock-acquisition graph
(counterpart of ``raft_tpu/analysis/rules/lock_order.py``).

The projectgraph builder records an edge ``A -> B`` whenever lock ``B`` is
taken while ``A`` is held — directly (a nested ``with``), or through a call
the intra-repo call graph can resolve (self-methods, attribute receivers
typed by ``self.x = ClassName(...)`` in ``__init__``, module functions via
the import table) using per-function may-acquire summaries. Two findings:

* **cycle** — a strongly connected component of two or more locks: some
  interleaving of the involved threads can deadlock. Emitted once per
  cycle, anchored at the lexicographically first edge site in the cycle.
* **self-deadlock** — a non-reentrant ``threading.Lock`` acquired while
  already held on the same path (``RLock``/``Condition``/semaphores are
  reentrant-by-design and exempt).

Dump the graph for inspection::

    python -m raft_tpu_torch.analysis --rule lock-order --graph out.json raft_tpu_torch
"""

from __future__ import annotations

from raft_tpu_torch.analysis.registry import Rule, register
from raft_tpu_torch.analysis.rules.guarded_state import _Anchor


@register
class LockOrderRule(Rule):
    id = "lock-order"
    severity = "error"
    description = ("cycle in the repo-wide lock-acquisition graph, or a "
                   "non-reentrant lock re-acquired while held")

    def check(self, ctx):
        if ctx.project is None:
            return
        graph = ctx.project.lock_graph()
        for cycle in graph["cycles"]:
            members = set(cycle)
            sites = sorted(
                (s for s in graph["edges"]
                 if s.held in members and s.taken in members),
                key=lambda s: (s.rel, s.line))
            if not sites or sites[0].rel != ctx.rel:
                continue
            yield self.finding(
                ctx, _Anchor(sites[0].line),
                "lock-acquisition cycle: " + " -> ".join(cycle + [cycle[0]])
                + " (some thread interleaving can deadlock; break the cycle "
                  "or impose a global order)")
        for site in graph["self_deadlocks"]:
            if site.rel != ctx.rel:
                continue
            yield self.finding(
                ctx, _Anchor(site.line),
                f"non-reentrant lock {site.taken} acquired while already "
                f"held on this path (threading.Lock self-deadlocks; use an "
                f"RLock or restructure)")
