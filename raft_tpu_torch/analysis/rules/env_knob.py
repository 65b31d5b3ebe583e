"""env-knob: drift check for ``RAFT_TPU_*`` environment knobs (counterpart
of ``raft_tpu/analysis/rules/env_knob.py``; the port reads the same knobs,
so the prefix stays ``RAFT_TPU_``).

Every knob the library reads is public API — it must be documented, and it
must have exactly one place that supplies its default (two modules each
defaulting the same knob agree today and silently diverge on the next
edit). Two findings:

* **undocumented** — a knob read somewhere in the scan never appears in a
  README.md table row (a line starting with ``|``) at the scan root.
  Skipped entirely when the root has no README.md (fixture trees).
* **doubly-defaulted** — more than one read site passes an explicit
  default for the same knob (2-arg ``os.environ.get`` / ``os.getenv`` or a
  ``_env_*``/``default_*`` helper call). Reads without a default (probe
  patterns, save/restore) don't count; the fix is to route every consumer
  through the one registered default.

Knob reads are collected from library files only — tests *set* knobs, they
don't define them.
"""

from __future__ import annotations

from raft_tpu_torch.analysis.registry import Rule, register
from raft_tpu_torch.analysis.rules.guarded_state import _Anchor


@register
class EnvKnobRule(Rule):
    id = "env-knob"
    severity = "error"
    description = ("RAFT_TPU_* env knob missing from the README knob table "
                   "or defaulted in more than one read site")

    def check(self, ctx):
        project = ctx.project
        if project is None:
            return
        reads = project.knob_reads()
        documented = self._documented(project)
        # knob -> {module rel: first defaulted line}; drift = two MODULES
        # each defaulting the same knob (repeat reads through one module's
        # helper are that module's business)
        defaulted: dict = {}
        for rel, line, knob, has_default in reads:
            if has_default:
                mods = defaulted.setdefault(knob, {})
                mods.setdefault(rel, line)
        emitted = set()
        for rel, line, knob, has_default in reads:
            if rel != ctx.rel:
                continue
            if documented is not None and knob not in documented:
                first = min((r, ln) for r, ln, k, _ in reads if k == knob)
                if (rel, line) == first:
                    yield self.finding(
                        ctx, _Anchor(line),
                        f"env knob '{knob}' is read here but appears in no "
                        f"README knob-table row (document it or drop it)")
            mods = defaulted.get(knob, {})
            if len(mods) > 1 and rel in mods and (knob, rel) not in emitted \
                    and line == mods[rel]:
                emitted.add((knob, rel))
                others = ", ".join(f"{r}:{ln}" for r, ln in sorted(mods.items())
                                   if r != rel)
                yield self.finding(
                    ctx, _Anchor(line),
                    f"env knob '{knob}' is defaulted in more than one "
                    f"module (also at {others}); route all consumers "
                    f"through one registered default")

    @staticmethod
    def _documented(project):
        """Knob names in README table rows, or None when no README exists
        (fixture scans check only double-defaulting); read once a scan."""
        if not hasattr(project, "_readme_knobs"):
            project._readme_knobs = EnvKnobRule._read_readme(project)
        return project._readme_knobs

    @staticmethod
    def _read_readme(project):
        readme = project.root / "README.md"
        if not readme.exists():
            return None
        names = set()
        for line in readme.read_text(encoding="utf-8",
                                     errors="replace").splitlines():
            if line.lstrip().startswith("|"):
                for tok in line.replace("`", " ").replace("|", " ").split():
                    if tok.startswith("RAFT_TPU_"):
                        names.add(tok.strip(".,:;()"))
        return names
