"""One run of one cell: find the cell's files by name, run its loop, judge
its answers, print the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``<config file>`` (the ``file`` of a ``configs`` entry): the deployment;
  its ``data.recipe`` names ``cardbench/data/<recipe>.py``;
* ``cardbench/traffic/<traffic>.json``: the traffic mix; its ``loop``
  names ``cardbench/loops/<loop>.py``, the generator that drives it;
* ``cardbench/metrics/<metric>.py``: the reader of one per-layer metric.

A loop module has ``run(r: Run) -> dict`` (see :class:`Run`), whose
``e2e`` holds the end-to-end metrics it measures by name. A metric named
``<quantity>.<qualifier>`` (one quantity, bounded apart in a group of
cells) takes the loop's value, or the reader file, of ``<quantity>``
where it has none of its own (:func:`qualified`). A recipe
module has ``make(spec, n_queries, seed, device) -> (rows, queries)``; a
metric reader has ``read(trace) -> float | None``, where ``trace`` is the
loop's :class:`cardbench.trace.Trace`, and returns None when it finds
nothing to read.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parent.parent

#: top-level module names the process must not hold: JAX, its libraries and
#: the JAX package this port stands beside (compared whole: the port's own
#: name, ``raft_tpu_torch``, begins with ``raft_tpu``)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "raft_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``), each module name cut at its first dot."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN_MODULES))


def derive(seed: int, *salt) -> int:
    """A 63-bit seed for one use of the run's ``--seed``: a hash of the seed
    and the salt, so two uses never share a stream."""
    h = hashlib.blake2b(repr((int(seed),) + salt).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def qualified(name: str, has) -> Optional[str]:
    """``name``, or the longest part of it cut at a dot for which ``has``
    is true; None if there is none."""
    parts = name.split(".")
    for i in range(len(parts), 0, -1):
        if has(".".join(parts[:i])):
            return ".".join(parts[:i])
    return None


def load_module(path: Path, tag: str):
    """The Python file at ``path``, imported under a private module name."""
    name = "cardbench_" + "".join(c if c.isalnum() else "_" for c in tag)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


@dataclass
class Cell:
    """A ``workloads`` entry with its configuration, traffic mix and the
    metrics that ``BENCHMARK.json`` asks of it."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(root: Path, workload: str) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in spec["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = by_name[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "cardbench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer)


@dataclass
class Run:
    """What a loop gets: the cell, the run's arguments, the device and the
    process's start on the host clock (set-up counts from there)."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    root: Path
    t_start: float

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def limits(self) -> dict:
        """The limits of the comparison: the configuration's, with the
        traffic mix's where it states its own."""
        return {**self.config.get("limits", {}),
                **self.traffic.get("limits", {})}

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_start

    def data(self, n_queries: int):
        """(rows, queries) of the configuration's recipe on the run's
        device: the rows from the configuration's data seed, so every run
        serves the same rows, as a deployment's data set is; the query
        pool from the run's seed, each mixture component drawn as often
        whatever the seed."""
        spec = self.config["data"]
        mod = load_module(self.root / "cardbench" / "data"
                          / f"{spec['recipe']}.py", "data_" + spec["recipe"])
        return mod.make(spec, n_queries, derive(self.seed, "queries"),
                        self.device)

    def traffic_keys(self, known) -> dict:
        """The traffic mix, once it is checked to hold no key but ``loop``,
        ``why`` and ``known``: a key that the loop would not read is an
        error, not a setting."""
        extra = sorted(set(self.traffic) - {"loop", "why"} - set(known))
        if extra:
            raise ValueError(f"loop {self.traffic['loop']!r} reads no "
                             f"traffic key {extra}")
        return self.traffic

    def filter_mask(self, n: int):
        """The traffic mix's filter (``filter_pass``: the share of rows it
        passes, drawn at random from the seed) as a bool mask over ``n``
        rows, or None."""
        share = self.traffic.get("filter_pass")
        if share is None:
            return None
        import torch

        g = torch.Generator(device=self.device)
        g.manual_seed(derive(self.seed, "filter"))
        return torch.rand(n, generator=g, device=self.device) < float(share)


def metric_file(root: Path, name: str) -> Path:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or
    that of its unqualified quantity (:func:`qualified`)."""
    d = root / "cardbench" / "metrics"
    found = qualified(name, lambda n: (d / f"{n}.py").is_file())
    if found is None:
        raise FileNotFoundError(d / f"{name}.py")
    return d / f"{found}.py"


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: Optional[str] = None,
             t_start: Optional[float] = None) -> dict:
    """One run of ``workload``; returns the result line as a dict.
    ``device`` None means the card, which must be there (``cuda:0``);
    tests pass ``"cpu"``. Set-up counts from ``t_start`` (default: now)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(root, workload)
    import torch

    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            raise SystemExit(
                f"{workload} needs {cell.chips} CUDA device(s); "
                f"cuda available: {torch.cuda.is_available()}, count: "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = "cuda:0"
    dev = torch.device(device)
    run = Run(cell, int(seed), float(seconds), bool(trace), dev, root, t_start)
    loop = load_module(root / "cardbench" / "loops"
                       / f"{cell.traffic['loop']}.py",
                       "loop_" + cell.traffic["loop"])
    out = loop.run(run)
    checks = out["checks"]
    correct = all(c["ok"] for c in checks) and out["failed"] == 0
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            key = qualified(m["name"], out["e2e"].__contains__)
            value = None if key is None else out["e2e"][key]
            if value is None:
                raise RuntimeError(f"{workload}: the loop gave no "
                                   f"{m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        tr = out["trace"]
        for m in cell.per_layer:
            reader = load_module(metric_file(root, m["name"]),
                                 "metric_" + m["name"])
            value = reader.read(tr)
            if value is not None:
                if not math.isfinite(value):
                    raise RuntimeError(f"{m['name']} read {value}")
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                  "count": cell.chips,
                  "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": bool(correct), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics,
            "device": device_rec}
    if trace:
        tr = out["trace"]
        device_rec["busy_s"] = tr.busy_s
        device_rec["window_s"] = tr.window_s
        line["breakdown"] = tr.breakdown
    line["checks"] = {c["name"]: {"value": json_number(c["value"]),
                                  "limit": c["limit"], "rule": c["rule"]}
                      for c in checks}
    return line


def json_number(value):
    """``value`` as strict JSON holds it: a non-finite float as its name."""
    if isinstance(value, float) and not math.isfinite(value):
        return repr(value)
    return value


def check(name: str, value, rule: str, limit) -> dict:
    """One number of the comparison beside its limit: ``rule`` is ``<=``
    or ``>=``."""
    ok = value <= limit if rule == "<=" else value >= limit
    return {"name": name, "value": value, "rule": rule, "limit": limit,
            "ok": bool(ok)}


def emit(line: dict) -> None:
    """The checks as the last lines on standard error, then the result as
    the last line on standard output."""
    for name, c in line["checks"].items():
        log(f"check {name} = {c['value']!r} (must be {c['rule']} "
            f"{c['limit']!r})")
    log(f"correct = {line['correct']}")
    print(json.dumps(line), flush=True)


def set_cache_dirs(root: Path) -> None:
    """Fixed cache directories inside the checkout for anything that
    compiles at run time (the port's own nvcc builds already go to
    ``raft_tpu_torch/_build/``)."""
    cache = root / "cardbench" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv_compute")


def main(argv: Optional[List[str]] = None,
         t_start: Optional[float] = None) -> int:
    import argparse

    t0 = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    set_cache_dirs(ROOT)
    line = run_cell(ROOT, a.workload, a.seed, a.seconds, bool(a.trace),
                    t_start=t0)
    line_t = time.perf_counter() - t0
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 3
    log(f"run took {line_t:.3f} s")
    emit(line)
    return 0
