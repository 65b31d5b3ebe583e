"""What a traced run (``--trace 1``) records, and its reduction.

* :class:`LayerClock`: CUDA events around each call into a layer, taken
  from the benchmark's own files; times on the card's clock.
* :class:`Profile`: ``torch.profiler`` (CPU and CUDA activities) over the
  measured window, reduced to the seconds the device was busy (the union
  of its kernels, copies and fills), device time by operation name, and
  idle time by what the host was doing when the device went idle.
* :class:`Trace`: what the per-layer readers (``cardbench/metrics/``) read.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from cardbench.harness import log

#: activity types of the profiler that are work on the device
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
#: the label the loops wrap their whole window in
WINDOW_LABEL = "cardbench.window"
TOP = 10
#: characters of an operation's name kept in the breakdown
NAME_CHARS = 120


class LayerClock:
    """Marks on the card's clock (CUDA events; the host clock on the CPU,
    which only tests use), paired per layer call."""

    def __init__(self, device):
        import torch

        self._torch = torch
        self.cuda = device.type == "cuda"
        self.pairs: Dict[str, list] = defaultdict(list)

    def mark(self):
        if self.cuda:
            ev = self._torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def add(self, label: str, start, end) -> None:
        self.pairs[label].append((start, end))

    def ms(self) -> Dict[str, List[float]]:
        """Milliseconds of every pair, by label (synchronises)."""
        if self.cuda:
            self._torch.cuda.synchronize()
            return {k: [a.elapsed_time(b) for a, b in v]
                    for k, v in self.pairs.items()}
        return {k: [(b - a) * 1e3 for a, b in v]
                for k, v in self.pairs.items()}


@dataclass
class Trace:
    """A traced run's readings. ``layer_ms``: CUDA-event milliseconds per
    call by layer; ``device_ops``: device seconds by operation name over
    the profiled window; ``spans``: the port's own span records (sync
    mode) where the loop enabled them; ``work``: the yardstick's counts
    (``cardbench/roofline``), by kernel."""

    window_s: float = 0.0
    busy_s: float = 0.0
    device_ops: Dict[str, float] = field(default_factory=dict)
    idle_by_host: Dict[str, float] = field(default_factory=dict)
    layer_ms: Dict[str, List[float]] = field(default_factory=dict)
    spans: List[dict] = field(default_factory=list)
    work: Dict[str, dict] = field(default_factory=dict)
    builds: int = 0

    @property
    def idle_share(self) -> Optional[float]:
        """Percent of the profiled window in which nothing ran on the
        device; None where the trace holds no device work."""
        if self.busy_s <= 0 or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    @property
    def breakdown(self) -> dict:
        def top(d):
            return [[k[:NAME_CHARS], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.device_ops),
                "idle_gaps": top(self.idle_by_host)}


class Profile:
    """``with Profile(trace, device): ...`` profiles the block and fills
    ``trace.window_s``, ``busy_s``, ``device_ops`` and ``idle_by_host``.
    The block starts and ends with the device drained."""

    def __init__(self, trace: Trace, device):
        import torch

        self._torch = torch
        self.trace = trace
        self.cuda = device.type == "cuda"
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        if self.cuda:
            self._torch.cuda.synchronize()
        self.prof.__enter__()
        self._label = self._torch.profiler.record_function(WINDOW_LABEL)
        self._label.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self._torch.cuda.synchronize()
        self.trace.window_s = time.perf_counter() - self.t0
        self._label.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            t = time.perf_counter()
            reduce_events(self.prof.profiler.kineto_results.events(),
                          self.trace)
            log(f"trace: {len(self.trace.device_ops)} device op names, busy "
                f"{self.trace.busy_s:.4f} of {self.trace.window_s:.4f} s, "
                f"reduced in {time.perf_counter() - t:.2f} s")
        return False


def union_seconds(intervals: List[Tuple[int, int]]) -> Tuple[float, list]:
    """(seconds covered by the union of ``(start_ns, end_ns)`` intervals,
    the gaps between the merged intervals as ``(start_ns, end_ns)``)."""
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-9, gaps


def _interval(ev) -> Tuple[int, int]:
    start = ev.start_ns()
    return start, start + ev.duration_ns()


def _is_device(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def reduce_events(events, trace: Trace) -> None:
    """Fill ``trace`` from the profiler's raw events: device work (kernels,
    copies, fills) and host operations, both on the profiler's clock.
    Where the events carry no activity type (older torch), the device's
    user annotations are told from its work by name: each is the device
    copy of a host range of the same name."""
    dev, host = [], []
    window = None
    typed = None
    for ev in events:
        if typed is None:
            typed = hasattr(ev, "activity_type")
        if _is_device(ev):
            if not typed or ev.activity_type() in DEVICE_WORK:
                dev.append(_interval(ev) + (ev.name(),))
        elif ev.name() == WINDOW_LABEL:
            window = _interval(ev)
        else:
            host.append(_interval(ev) + (ev.name(),))
    if not typed:
        ranges = {name for _, _, name in host} | {WINDOW_LABEL}
        dev = [d for d in dev if d[2] not in ranges]
    ops: Dict[str, float] = defaultdict(float)
    for s, e, name in dev:
        ops[name] += (e - s) * 1e-9
    trace.device_ops = dict(ops)
    busy, gaps = union_seconds([(s, e) for s, e, _ in dev])
    trace.busy_s = busy
    if not dev or window is None:
        return
    first = min(s for s, _, _ in dev)
    last = max(e for _, e, _ in dev)
    gaps = [(window[0], first)] + gaps + [(last, window[1])]
    trace.idle_by_host = idle_by_host(gaps, host)


def idle_by_host(gaps, host) -> Dict[str, float]:
    """Idle seconds by the innermost host operation running at each gap's
    midpoint ("host python" where none was)."""
    out: Dict[str, float] = defaultdict(float)
    host = sorted(host)
    active: list = []
    i = 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        name = max(active)[2] if active else "host python"
        out[name] += (g1 - g0) * 1e-9
    return dict(out)
