"""Finding record + report formats (text and JSON), as in
``raft_tpu/analysis/findings.py``.

The text format is ``file:line · rule-id · severity · message`` —
grep-friendly and clickable in most terminals. The JSON format
is a list of objects (one per finding) for tooling.

A finding's identity for baseline purposes is deliberately line-number-FREE:
``(rule, path, snippet)`` where snippet is the stripped source line. Editing
code above a grandfathered finding must not un-baseline it; moving or
duplicating the offending line itself should.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field


class Severity:
    """Severity ladder. Only the spelling matters (baseline + output)."""

    ERROR = "error"
    WARNING = "warning"
    INFO = "info"

    _ORDER = {ERROR: 0, WARNING: 1, INFO: 2}

    @classmethod
    def rank(cls, sev: str) -> int:
        return cls._ORDER.get(sev, 99)


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    path: str          # repo-relative, forward slashes
    line: int          # 1-based
    rule: str
    severity: str
    message: str
    snippet: str = field(default="", compare=False)

    def key(self) -> tuple:
        """Baseline identity: stable under edits elsewhere in the file."""
        return (self.rule, self.path, self.snippet)

    def to_dict(self) -> dict:
        return {
            "path": self.path,
            "line": self.line,
            "rule": self.rule,
            "severity": self.severity,
            "message": self.message,
            "snippet": self.snippet,
        }


def sort_findings(findings) -> list:
    return sorted(
        findings,
        key=lambda f: (f.path, f.line, Severity.rank(f.severity), f.rule),
    )


def format_text(findings, baselined: int = 0) -> str:
    """``file:line · rule-id · severity · message`` lines + a summary tail."""
    lines = [
        f"{f.path}:{f.line} · {f.rule} · {f.severity} · {f.message}"
        for f in sort_findings(findings)
    ]
    n = len(lines)
    summary = f"graftlint: {n} new finding{'s' if n != 1 else ''}"
    if baselined:
        summary += f" ({baselined} baselined, suppressed)"
    lines.append(summary)
    return "\n".join(lines)


def format_json(findings, baselined: int = 0) -> str:
    fs = sort_findings(findings)
    return json.dumps(
        {
            "findings": [f.to_dict() for f in fs],
            "new": len(fs),
            "baselined": baselined,
        },
        indent=2,
    )
