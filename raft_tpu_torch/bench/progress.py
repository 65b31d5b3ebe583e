"""Checkpointed bench runs (counterpart of ``raft_tpu/bench/progress.py``):
a heartbeat JSONL side-channel, crash-safe artifacts, and salvage.

A bench run that dies mid-suite must still leave what it finished: the
measurement child appends one JSONL record to a side-channel file the
moment each suite section completes (plus a periodic heartbeat line, so a
wedge is distinguishable from slow progress), and :func:`salvage`
reconstructs the best-available headline metric line from whatever
checkpoints survived a kill.

Record types (one JSON object per line; every record carries ``t`` epoch
seconds and ``elapsed_s`` since the writer started):

* ``run_start``  — platform + the suite config (n/dim/q/k/dataset)
* ``section``    — ``name`` + ``data`` (the section's extras dict), written
  the moment the section finishes
* ``heartbeat``  — periodic pulse with the in-progress ``section`` name
* ``run_end``    — final headline metric (present only on clean completion)

Stdlib only on purpose: a parent that never imports torch reads the file
after a failed run, and every obs/tuning writer (:func:`export_metrics`,
:func:`write_artifact`) routes through this module's fsync'd channel. A
torn last line (a kill mid-append) is skipped by :func:`read_progress`.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

ENV_VAR = "RAFT_TPU_BENCH_HEARTBEAT"
DEFAULT_PATH = os.path.join("results", "bench_progress.jsonl")


def process_info() -> tuple:
    """(process_index, process_count) for stamping records — the
    stdlib-only twin of ``obs/tracing.process_info`` (this module shares no
    code with the obs package, so it loads in a parent that never imported
    torch). Same contract: ``RAFT_TPU_PROCESS_INDEX`` /
    ``RAFT_TPU_PROCESS_COUNT`` first, then an ALREADY initialised
    ``torch.distributed`` group (looked up in ``sys.modules``, never
    imported), else ``(0, 1)``. Never touches CUDA."""
    import sys as _sys

    pi = os.environ.get("RAFT_TPU_PROCESS_INDEX", "").strip()
    pc = os.environ.get("RAFT_TPU_PROCESS_COUNT", "").strip()
    if pi.lstrip("-").isdigit():
        return int(pi), int(pc) if pc.lstrip("-").isdigit() else 1
    dist = _sys.modules.get("torch.distributed")
    if dist is not None:
        try:
            if dist.is_available() and dist.is_initialized():
                return int(dist.get_rank()), int(dist.get_world_size())
        # a stamp is best-effort decoration on a crash-safety path: a
        # half-torn-down group degrades to (0, 1), never blocks a checkpoint
        except (RuntimeError, ValueError):
            pass
    return 0, 1

# single home of the headline denominator (bench.py reads it from here so a
# retune cannot diverge between live and salvaged lines)
NORTH_STAR_QPS = 1e6

# salvage headline preference: same order bench.py would pick its headline
_HEADLINE_ORDER = ("ivf_pq", "ivf_flat", "brute_force", "cagra")


class ProgressWriter:
    """Crash-safe appender: every record is written, flushed and fsync'd in
    one call, so a SIGKILL between sections loses at most the in-flight
    line. A daemon pulse thread emits heartbeats every ``pulse_interval_s``.
    """

    def __init__(self, path: str, platform: str = "",
                 pulse_interval_s: float = 15.0):
        self.path = path
        self._platform = platform
        self._interval = pulse_interval_s
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._section = ""
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def _write(self, rec: dict) -> None:
        pi, pc = process_info()
        rec = {
            "t": round(time.time(), 3),
            "elapsed_s": round(time.monotonic() - self._t0, 3),
            "process_index": pi,
            "process_count": pc,
            **rec,
        }
        line = json.dumps(rec)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line + "\n")
                f.flush()
                os.fsync(f.fileno())

    def start(self, config: Optional[dict] = None) -> None:
        self._write({"type": "run_start", "platform": self._platform,
                     "config": config or {}})
        self._thread = threading.Thread(target=self._pulse, daemon=True)
        self._thread.start()

    def set_section(self, name: str) -> None:
        """Mark ``name`` as in progress (heartbeat lines carry it, so a
        post-mortem shows WHERE the run wedged)."""
        self._section = name

    def section(self, name: str, data: dict) -> None:
        """Checkpoint one completed suite section."""
        self._section = ""
        self._write({"type": "section", "name": name,
                     "platform": self._platform, "data": data})

    def finish(self, result: Optional[dict] = None) -> None:
        self._stop.set()
        self._write({"type": "run_end", "platform": self._platform,
                     "result": result or {}})

    def _pulse(self) -> None:
        while not self._stop.wait(self._interval):
            self._write({"type": "heartbeat", "section": self._section})


class NullProgress:
    """No-op writer (heartbeat channel not configured)."""

    path = ""

    def start(self, config=None):
        pass

    def set_section(self, name):
        pass

    def section(self, name, data):
        pass

    def finish(self, result=None):
        pass


def truncate(path: str) -> None:
    """Start a fresh heartbeat file for a new run (the orchestrator's
    per-run reset). Lives here so every touch of the side-channel file —
    create, append, reset — goes through this module's contract."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w"):
        pass


def truncate_dir(directory: str, suffix: str = ".jsonl",
                 prefix: str = "") -> None:
    """Per-attempt reset of telemetry artifacts: remove stale per-process
    files so a fleet merge (or a Perfetto view) never folds in a dead
    attempt's output. ``prefix`` scopes the sweep when the directory also
    holds unrelated files (results/ keeps committed round artifacts)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return
    for name in names:
        # the + ".tmp" arm sweeps write_artifact temp files a SIGKILL
        # stranded mid-write (os.replace never ran)
        if (name.endswith(suffix) or name.endswith(suffix + ".tmp")) and \
                name.startswith(prefix):
            try:
                os.remove(os.path.join(directory, name))
            except OSError:
                pass


def write_artifact(path: str, doc: dict) -> None:
    """Crash-safely write one JSON artifact — tmp file, flush, fsync, then
    atomic ``os.replace`` — the sanctioned channel for bench-side trace
    exports and fleet views: a kill mid-write leaves either the old file or
    the complete new one, never a torn one (graftlint's span-name rule
    points direct exports here)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def export_metrics(path: str, snapshot: dict,
                   extra: Optional[dict] = None) -> dict:
    """Append one process-stamped metrics snapshot line to ``path`` with the
    heartbeat file's durability (flush + fsync per record) — the bench-side
    analog of ``obs.export_jsonl`` (which flushes but does not fsync, and
    which bench code must not call directly). Returns the record written."""
    pi, pc = process_info()
    rec = {"t": round(time.time(), 3), "process_index": pi,
           "process_count": pc, **(extra or {}), **snapshot}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())
    return rec


def from_env(platform: str = ""):
    """The measurement child's entry: a real writer when the orchestrator
    exported ``RAFT_TPU_BENCH_HEARTBEAT``, else a no-op."""
    path = os.environ.get(ENV_VAR, "").strip()
    if not path:
        return NullProgress()
    return ProgressWriter(path, platform=platform)


def read_progress(path: str) -> List[dict]:
    """Parse a heartbeat file, skipping any torn/corrupt trailing line."""
    records = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict):
                    records.append(rec)
    except OSError:
        return []
    return records


def _shape_tag(config: dict) -> str:
    """The metric shape tag, built EXACTLY the way bench.py's run_suite
    builds it (``{ds}{n//1000}k_{dim}d_k{k}``) so a salvaged line lands in
    the same metric series as a live run of the identical config."""
    ds = str(config.get("dataset", "unknown"))
    n, dim, k = config.get("n"), config.get("dim"), config.get("k")
    if all(isinstance(v, int) and v > 0 for v in (n, dim, k)):
        base = "sift" if ds == "sift-real" else "siftlike"
        return f"{base}{n // 1000}k_{dim}d_k{k}"
    return ds


def _salvage_segment(segment: List[dict], source: str) -> Optional[dict]:
    """Salvage one run's records (run_start..next run_start); None when no
    section with a positive QPS exists. Last checkpoint per section wins."""
    config: dict = {}
    if segment and segment[0].get("type") == "run_start":
        config = segment[0].get("config") or {}
    sections: dict = {}
    platform = ""
    for rec in segment:
        if rec.get("type") == "section" and isinstance(rec.get("data"), dict):
            sections[rec.get("name")] = rec["data"]
            platform = rec.get("platform") or platform

    for name in _HEADLINE_ORDER:
        data = sections.get(name)
        if not isinstance(data, dict):
            continue
        qps = data.get("qps")
        if isinstance(qps, (int, float)) and qps > 0:
            break
    else:
        return None

    recall = data.get("recall")
    metric = f"{name}_qps_{_shape_tag(config)}"
    # recall suffix parity with run_suite: ivf headlines carry it, the
    # brute-force anchor does not
    if name != "brute_force" and isinstance(recall, (int, float)):
        metric += f"_recall{recall}"
    out = {
        "metric": metric,
        "value": float(qps),
        "unit": "QPS",
        "vs_baseline": round(float(qps) / NORTH_STAR_QPS, 4),
        "salvaged": True,
        "platform": platform,
        "note": "reconstructed from bench_progress.jsonl checkpoints "
                "(run died mid-suite)",
        "extras": {"config": config, **sections},
    }
    if isinstance(recall, (int, float)):
        out["recall_gate_met"] = bool(recall >= 0.95)
    if source:
        out["salvaged_from"] = source
    return out


def salvage(records: List[dict], source: str = "") -> Optional[dict]:
    """Reconstruct the best-available headline metric line from checkpoint
    records (tagged ``"salvaged": true``), or None when no section with a
    positive QPS survived anywhere in the file.

    Runs are separated by ``run_start`` records (a progress file may hold a
    failed TPU attempt followed by a CPU retry); the NEWEST run with a
    salvageable section wins, but a retry that died before its first
    checkpoint falls back to the previous attempt's sections rather than
    discarding them.
    """
    bounds = [i for i, r in enumerate(records)
              if r.get("type") == "run_start"]
    if not bounds or bounds[0] != 0:
        bounds.insert(0, 0)  # leading checkpoint(s) with no run_start marker
    bounds.append(len(records))
    for si in range(len(bounds) - 2, -1, -1):
        line = _salvage_segment(records[bounds[si]:bounds[si + 1]], source)
        if line is not None:
            return line
    return None
