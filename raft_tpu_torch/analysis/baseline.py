"""Baseline store: grandfathered findings that stay silent until they move.

The baseline is a checked-in JSON file mapping finding identities
(``rule`` + ``path`` + source ``snippet`` — line numbers deliberately
excluded, see findings.Finding.key) to an allowed ``count`` and a one-line
human ``justification``. The analyzer subtracts the baseline from its raw
findings; anything left is NEW and fails the run. A baselined line that is
fixed simply stops matching (stale entries are pruned on regeneration);
a baselined pattern that spreads (count exceeded) gets loud again.

The port's baseline is its own file, ``raft_tpu_torch/analysis/baseline.json``
(:data:`DEFAULT_PATH`; the CLI's default under its ``--root``), with the
JAX package's schema: ``rule``, ``path``, ``snippet``, ``count``,
``severity``, ``justification``.

Regeneration is a deliberate act (``python -m
raft_tpu_torch.analysis.write_baseline``), never a side effect of a normal
run — an auto-refreshing baseline would grandfather every regression the
moment it lands.
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Iterable, List, Optional, Tuple

from raft_tpu_torch.analysis.findings import Finding

_VERSION = 1
#: the port's checked-in baseline, shipped inside the package
DEFAULT_PATH = Path(__file__).resolve().parent / "baseline.json"
_TODO = "TODO: justify or fix"


class Baseline:
    """In-memory view of the baseline file."""

    def __init__(self, entries: Optional[List[dict]] = None):
        self.entries = entries or []

    # -- persistence --------------------------------------------------------

    @classmethod
    def load(cls, path) -> "Baseline":
        path = Path(path)
        if not path.exists():
            return cls([])
        data = json.loads(path.read_text(encoding="utf-8"))
        entries = data.get("entries", []) if isinstance(data, dict) else data
        return cls([e for e in entries if isinstance(e, dict)])

    def save(self, path) -> None:
        from raft_tpu_torch.core.fsio import atomic_write

        entries = sorted(
            self.entries,
            key=lambda e: (e.get("path", ""), e.get("rule", ""),
                           e.get("snippet", "")),
        )
        payload = {
            "version": _VERSION,
            "tool": "graftlint (raft_tpu_torch.analysis)",
            "note": "regenerate DELIBERATELY via python -m "
                    "raft_tpu_torch.analysis.write_baseline; every entry "
                    "needs a one-line justification",
            "entries": entries,
        }
        # atomic: a baseline truncated by a mid-write kill would
        # turn every grandfathered finding loud on the next tier-1 run
        with atomic_write(Path(path), "w") as f:
            f.write(json.dumps(payload, indent=2) + "\n")

    # -- matching -----------------------------------------------------------

    def _allowance(self) -> Counter:
        c: Counter = Counter()
        for e in self.entries:
            key = (e.get("rule", ""), e.get("path", ""), e.get("snippet", ""))
            c[key] += int(e.get("count", 1))
        return c

    def filter(self, findings: Iterable[Finding]) -> Tuple[List[Finding], int]:
        """Split findings into (new, n_baselined). Each baseline entry
        absorbs up to ``count`` findings with the same identity."""
        allowance = self._allowance()
        new: List[Finding] = []
        absorbed = 0
        for f in findings:
            if allowance.get(f.key(), 0) > 0:
                allowance[f.key()] -= 1
                absorbed += 1
            else:
                new.append(f)
        return new, absorbed

    # -- regeneration -------------------------------------------------------

    @classmethod
    def from_findings(cls, findings: Iterable[Finding],
                      previous: Optional["Baseline"] = None) -> "Baseline":
        """Build a fresh baseline covering ``findings`` exactly, carrying
        justifications (and nothing else) forward from ``previous``."""
        just = {}
        if previous is not None:
            for e in previous.entries:
                key = (e.get("rule", ""), e.get("path", ""),
                       e.get("snippet", ""))
                if e.get("justification") and e["justification"] != _TODO:
                    just[key] = e["justification"]
        counts: Counter = Counter(f.key() for f in findings)
        sev = {f.key(): f.severity for f in findings}
        entries = []
        for (rule, path, snippet), count in sorted(counts.items()):
            key = (rule, path, snippet)
            entries.append({
                "rule": rule,
                "path": path,
                "snippet": snippet,
                "count": count,
                "severity": sev[key],
                "justification": just.get(key, _TODO),
            })
        return cls(entries)

    def todo_entries(self) -> List[dict]:
        """Entries still carrying the placeholder justification."""
        return [e for e in self.entries if e.get("justification") == _TODO]
