"""banned-api: nondeterminism sources in kernel/ops modules (counterpart
of ``raft_tpu/analysis/rules/banned_api.py``).

``raft_tpu_torch/ops`` and ``raft_tpu_torch/native`` are the numerical
core — the same inputs must produce the same launches on every call
(reproducible benches, bit-identical builds, and the determinism contract
distributed replay depends on). Wall-clock reads, stdlib ``random`` and
``datetime`` have no business there; timing belongs in ``@traced``/``obs``
at the entry points, randomness must flow through an explicit
``torch.Generator`` made from a seed (``raft_tpu_torch/random``), and
``np.random`` hides global mutable state.
"""

from __future__ import annotations

import ast

from raft_tpu_torch.analysis.jit_regions import walk
from raft_tpu_torch.analysis.registry import Rule, register
from raft_tpu_torch.analysis.rules._common import resolve_call

_SCOPED_DIRS = {"ops", "native"}

_BANNED_PREFIXES = ("time.", "random.", "numpy.random.")
_BANNED_EXACT = {
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}


@register
class BannedApiRule(Rule):
    id = "banned-api"
    severity = "error"
    description = ("time/random/datetime/np.random calls in kernel & ops "
                   "modules (determinism contract)")

    def check(self, ctx):
        parts = ctx.rel.split("/")[:-1]
        if not _SCOPED_DIRS.intersection(parts) and \
                "kernels" not in ctx.rel.split("/")[-1]:
            return
        for node in walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            resolved = resolve_call(ctx, node.func)
            if not resolved:
                continue
            if resolved in _BANNED_EXACT or \
                    resolved.startswith(_BANNED_PREFIXES):
                yield self.finding(
                    ctx, node,
                    f"`{resolved}` in a kernel/ops module breaks the "
                    f"determinism contract — draw from a seeded "
                    f"torch.Generator / move timing to @traced entry "
                    f"points")
