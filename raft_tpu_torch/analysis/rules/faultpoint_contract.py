"""faultpoint-contract: two-way drift check between faultpoints and tests
(counterpart of ``raft_tpu/analysis/rules/faultpoint_contract.py``).

Every ``resilience.faultpoint(<site>)`` call in library code is a recovery
contract — some tier-1 test must arm it via ``RAFT_TPU_FAULTS`` and assert
the degraded/classified behavior. This rule mechanizes both directions of
that contract over the scan set:

* **unarmed faultpoint** — a library faultpoint site that no collected
  arming string can name. Emitted only when the scan includes at least one
  test file (a library-only scan proves nothing about arming).
* **unknown arming site** — an arming string in tests naming a site no
  library faultpoint declares (stale after a rename; the test silently
  stops testing anything). Emitted only when the scan includes at least
  one library file.

Arming strings are collected from **all** string literals in test files
that parse as a valid spec (``site=kind[:count[:arg]]`` with a known
kind) — that includes ``arm_faults()`` arguments, ``monkeypatch.setenv``
values, and ``pytest.mark.parametrize`` tables — excluding anything inside
``@pytest.mark.slow`` (not tier-1, proves nothing). F-string sites on
either side (e.g. the distributed per-algo sites) match as patterns, and a
literal site handed to a local helper that calls ``faultpoint(param)``
(``_filter_plan("ivf_pq.search.filter", ...)``) counts as a site.

Deliberately synthetic sites in unit tests of the fault machinery itself
carry ``# graftlint: ignore[faultpoint-contract]``.
"""

from __future__ import annotations

from raft_tpu_torch.analysis.registry import Rule, register
from raft_tpu_torch.analysis.projectgraph import _is_test_rel, sites_compatible
from raft_tpu_torch.analysis.rules.guarded_state import _Anchor


@register
class FaultpointContractRule(Rule):
    id = "faultpoint-contract"
    severity = "error"
    description = ("library faultpoint no tier-1 test arms, or an arming "
                   "string naming a nonexistent faultpoint site")

    def check(self, ctx):
        project = ctx.project
        if project is None:
            return
        faults = project.faultpoint_sites()
        arms = project.arming_sites()
        have_tests = any(_is_test_rel(r) for r in project.contexts)
        have_lib = any(not _is_test_rel(r) for r in project.contexts)
        if have_tests and not _is_test_rel(ctx.rel):
            for rel, line, site, pat in faults:
                if rel != ctx.rel:
                    continue
                if any(sites_compatible(site, pat, a_site, a_pat)
                       for _, _, a_site, a_pat in arms):
                    continue
                yield self.finding(
                    ctx, _Anchor(line),
                    f"faultpoint '{site}' is armed by no tier-1 test "
                    f"(add a RAFT_TPU_FAULTS recovery test or baseline "
                    f"with a justification)")
        if have_lib and _is_test_rel(ctx.rel):
            for rel, line, site, pat in arms:
                if rel != ctx.rel:
                    continue
                if any(sites_compatible(f_site, f_pat, site, pat)
                       for _, _, f_site, f_pat in faults):
                    continue
                yield self.finding(
                    ctx, _Anchor(line),
                    f"arming string targets '{site}' but no library "
                    f"faultpoint declares that site (stale name? the test "
                    f"arms nothing)")
