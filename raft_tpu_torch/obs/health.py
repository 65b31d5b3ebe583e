"""Device-health probe (counterpart of ``raft_tpu/obs/health.py``): can a
fresh process reach the card and run one small matmul on it, in bounded
time?

A wedged CUDA runtime or card shows as a hang in its initialisation, which
cannot be interrupted from inside the process. So the probe runs in a
fresh child that imports torch, runs one small matmul on ``cuda`` (or on
the CPU for ``platform="cpu"``), synchronises and prints a sentinel line;
the parent waits at most ``timeout`` seconds (clamped to
:data:`MAX_TIMEOUT`) and kills the child on overrun.

Import-light: no torch at module level, and the parent never touches CUDA.

Standalone: ``python -m raft_tpu_torch.obs.health [--platform cpu]
[--timeout 20]`` prints the report as JSON and exits 0 (healthy) or 1.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import asdict, dataclass
from typing import Optional

# hard ceiling on any single probe, whatever the caller asks for
MAX_TIMEOUT = 30.0

_SENTINEL = "RAFT_TPU_HEALTH_OK"


def _child_code(device: str) -> str:
    return (
        "import torch\n"
        f"dev = torch.device({device!r})\n"
        "x = torch.arange(64, dtype=torch.float32, device=dev).reshape(8, 8)\n"
        "v = float(torch.sum(x @ x.T))\n"
        "name = torch.cuda.get_device_name(dev) if dev.type == 'cuda' "
        "else 'cpu'\n"
        "print('" + _SENTINEL + "', dev.type, v, name.replace(' ', '_'), "
        "flush=True)\n"
    )


@dataclass
class HealthReport:
    healthy: bool
    platform: str  # platform requested ("default" = the card)
    backend: str  # device type the child ran on ("" if unknown)
    elapsed_s: float
    reason: str  # "" when healthy

    def as_dict(self) -> dict:
        return asdict(self)


def probe(
    platform: str = "default",
    timeout: float = 20.0,
    child_code: Optional[str] = None,
) -> HealthReport:
    """Run the health check in a fresh bounded subprocess.

    ``platform``: "default" probes ``cuda``; "cpu" probes the CPU.
    ``child_code`` overrides the child program (tests use it to simulate a
    hanging backend)."""
    timeout = min(float(timeout), MAX_TIMEOUT)
    code = (child_code if child_code is not None
            else _child_code("cpu" if platform == "cpu" else "cuda"))
    t0 = time.monotonic()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", code],
            capture_output=True,
            text=True,
            timeout=timeout,
        )
    except subprocess.TimeoutExpired:
        return HealthReport(
            False, platform, "", round(time.monotonic() - t0, 2),
            f"probe timed out after {timeout:g}s "
            "(device init or first op hang)",
        )
    elapsed = round(time.monotonic() - t0, 2)
    for line in (proc.stdout or "").splitlines():
        if line.startswith(_SENTINEL):
            parts = line.split()
            backend = parts[1] if len(parts) > 1 else ""
            return HealthReport(True, platform, backend, elapsed, "")
    return HealthReport(
        False, platform, "", elapsed,
        f"probe child rc={proc.returncode}; "
        f"stderr: {(proc.stderr or '')[-500:]}",
    )


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", default="default",
                    help='"default" (the card) or "cpu"')
    ap.add_argument("--timeout", type=float, default=20.0,
                    help=f"seconds before the probe is killed "
                         f"(clamped to {MAX_TIMEOUT:g})")
    args = ap.parse_args(argv)
    report = probe(args.platform, args.timeout)
    print(json.dumps(report.as_dict()))
    return 0 if report.healthy else 1


if __name__ == "__main__":
    sys.exit(main())
