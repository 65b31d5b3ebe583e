"""graftlint for the port (``raft_tpu_torch.analysis``) against the JAX
package's (``raft_tpu.analysis``).

Four layers:

* per-rule fixtures — for every rule, one snippet that MUST trigger it and
  one near-miss that must NOT: the JAX package's cases for the twelve
  generic ids (paths under ``raft_tpu_torch/``), torch cases for the four
  recast ids (``tensor-branch``, ``launch-host-sync``,
  ``loop-host-transfer``, ``recompile-hazard``), whose near-misses cover
  ``.shape``/``.dtype`` reads, syncs behind ``obs.enabled()`` and host code
  outside launch regions;
* parity — the twelve generic ids give the same ``(path, line, rule)``
  set as the JAX package's rules on one fixture tree with no jax and no
  torch calls (the JAX package is imported here, never by the port);
* baseline round-trip and the CLI, as in the JAX package's tests;
* the repo gate — ``raft_tpu_torch``, ``tests/test_torch_*.py`` and
  ``chip_smoke.py`` are clean against the port's own baseline, in bounded
  time, from a child process that initialises no CUDA and loads no jax.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from raft_tpu.analysis import analyze_paths as jax_analyze_paths
from raft_tpu_torch.analysis import (
    Baseline,
    all_rules,
    analyze_paths,
    format_json,
    format_text,
    get_rule,
)
from raft_tpu_torch.analysis.baseline import DEFAULT_PATH
from raft_tpu_torch.analysis.cli import main as cli_main
from raft_tpu_torch.analysis.write_baseline import scan_paths

REPO = Path(__file__).resolve().parent.parent

#: the JAX package's ids the port copies (scopes pointed at the port)
GENERIC_IDS = {"obs-coverage", "banned-api", "swallowed-exception",
               "mutable-default", "bench-io", "span-name",
               "unclassified-except", "unused-import", "guarded-state",
               "lock-order", "faultpoint-contract", "env-knob"}
#: the JAX package's JAX-idiom ids -> the port's recast ids
RECAST = {"tracer-branch": "tensor-branch",
          "jit-host-sync": "launch-host-sync",
          "loop-host-transfer": "loop-host-transfer",
          "recompile-hazard": "recompile-hazard"}

# ---------------------------------------------------------------------------
# generic fixtures: (rule-id, relative path, triggering source, near-miss),
# written with {pkg} for the package so the parity tree can lay each out
# under raft_tpu/ for the JAX rules and raft_tpu_torch/ for the port's
# ---------------------------------------------------------------------------

GENERIC_FIXTURES = [
    (
        "obs-coverage",
        "neighbors/mod.py",
        """
def build(dataset):
    return dataset
""",
        # near-miss: @traced decorator present (and a private helper is free)
        """
from {pkg}.core.trace import traced

@traced("mod::build")
def build(dataset):
    return _build_impl(dataset)

def _build_impl(dataset):
    return dataset
""",
    ),
    (
        "banned-api",
        "ops/kern.py",
        """
import time

def kernel(x):
    t0 = time.time()
    return x, t0
""",
        # near-miss: randomness drawn from a generator handed in
        """
def kernel(gen, shape):
    return gen.normal(shape)
""",
    ),
    (
        "swallowed-exception",
        "mod.py",
        """
def f(x):
    try:
        return x.ready()
    except:
        return None
""",
        # near-miss: narrow type, deliberate (frozen-dataclass cache idiom)
        """
def f(index, value):
    try:
        index._cache = value
    except AttributeError:
        pass
    return value
""",
    ),
    (
        "mutable-default",
        "mod.py",
        """
def f(x, acc=[]):
    acc.append(x)
    return acc
""",
        # near-miss: None sentinel
        """
def f(x, acc=None):
    if acc is None:
        acc = []
    acc.append(x)
    return acc
""",
    ),
    (
        "bench-io",
        "bench/writer.py",
        """
import json

def dump(results):
    with open("results/out.json", "w") as f:
        json.dump(results, f)
""",
        # near-miss: read-mode open is fine
        """
import json

def load(path):
    with open(path) as f:
        return json.load(f)
""",
    ),
    (
        "span-name",
        "{pkg}/bench/mod.py",
        """
from {pkg} import obs
from {pkg}.core.trace import traced

@traced("run suite")
def run(path):
    with obs.record_span("benchScan"):
        obs.export_jsonl(path)
""",
        # near-miss: module::phase names + the progress.py export channel
        """
from {pkg} import obs
from {pkg}.bench import progress
from {pkg}.core.trace import traced

@traced("bench.mod::run")
def run(path):
    with obs.record_span("bench.mod::scan"):
        progress.export_metrics(path, obs.snapshot())
""",
    ),
    (
        "unclassified-except",
        "bench.py",
        """
def run(section):
    try:
        return section()
    except Exception as e:
        return {"error": repr(e)[:300]}
""",
        # near-miss: the failure class is preserved via resilience.classify
        """
from {pkg}.resilience import classify

def run(section):
    try:
        return section()
    except Exception as e:
        return {"error": repr(e)[:300], "kind": classify(e)}
""",
    ),
    (
        "unused-import",
        "mod.py",
        """
import os
import sys

def f():
    return os.getpid()
""",
        # near-miss: used via attribute + quoted annotation + noqa escape
        """
import os
import typing
import {pkg}.analysis.rules  # noqa: F401

def f(x: "typing.Optional[int]"):
    return os.getpid()
""",
    ),
    # serving's public surface is METHOD-shaped (PagedListStore.upsert /
    # QueryQueue.submit), so obs-coverage walks class bodies there
    (
        "obs-coverage",
        "{pkg}/serving/mod.py",
        """
class Store:
    def upsert(self, vectors, ids):
        return len(ids)
""",
        """
from {pkg} import obs
from {pkg}.core.trace import traced

class Store:
    @traced("serving::upsert")
    def upsert(self, vectors, ids):
        return self._append(vectors, ids)

    def submit(self, query):
        with obs.record_span("serving::submit"):
            return query

    def _append(self, vectors, ids):
        return len(ids)
""",
    ),
    # spans in serving/ must file under the serving:: (or capacity::) prefix
    (
        "span-name",
        "{pkg}/serving/mod.py",
        """
from {pkg} import obs

def dispatch(batch):
    with obs.record_span("ivf_flat::dispatch"):
        return batch
""",
        """
from {pkg} import obs

def dispatch(batch):
    with obs.record_span("serving::dispatch"):
        return batch

def promote(name):
    with obs.record_span("capacity::promote"):
        return name
""",
    ),
    # the capacity plane's tier moves are entry points like search/upsert
    (
        "obs-coverage",
        "{pkg}/serving/capacity.py",
        """
class Controller:
    def promote(self, name):
        return name
""",
        """
from {pkg} import obs

class Controller:
    def promote(self, name):
        with obs.record_span("capacity::promote"):
            return name

    def demote(self, name):
        with obs.record_span("capacity::demote"):
            return name

    def make_room(self, shortfall):
        return []

    def report(self):
        return {}
""",
    ),
    # the obs plane's own entry points (slo.py, module functions AND
    # engine methods) must be span-covered
    (
        "obs-coverage",
        "{pkg}/obs/slo.py",
        """
class Engine:
    def evaluate(self):
        return {}
""",
        """
from {pkg} import obs

class Engine:
    def evaluate(self):
        with obs.record_span("obs.slo::evaluate"):
            return {}

    def sample(self):
        with obs.record_span("obs.slo::sample"):
            return {}

def latency_slo(name):
    return name
""",
    ),
    (
        "obs-coverage",
        "{pkg}/obs/costmodel.py",
        """
def estimate(entry, **shapes):
    return {"entry": entry}
""",
        """
from {pkg} import obs

def estimate(entry, **shapes):
    with obs.record_span("obs.costmodel::estimate"):
        return {"entry": entry}

def check_admission(predicted, entry=""):
    with obs.record_span("obs.costmodel::check_admission"):
        return {"verdict": "admit"}

def predict_index_bytes(kind, **layout):
    with obs.record_span("obs.costmodel::predict_index_bytes"):
        return 0

def index_layout(index):
    return {}

def paged_scan_estimator(store, k, n_probes):
    return lambda batch: 0
""",
    ),
    (
        "obs-coverage",
        "{pkg}/obs/roofline.py",
        """
def estimate_flops(entry, **shapes):
    return {"flops": 0}
""",
        """
from {pkg} import obs

def estimate_flops(entry, **shapes):
    with obs.record_span("obs.roofline::estimate_flops"):
        return {"flops": 0}

def utilization(entry, measured_s=None, **shapes):
    with obs.record_span("obs.roofline::utilization"):
        return {"bound": "unknown"}

def summary(snapshot=None):
    with obs.record_span("obs.roofline::summary"):
        return {"entries": {}}

def note_dispatch(entry, shapes, occupancy=None):
    return None

def platform_peaks():
    return {"source": "unknown"}
""",
    ),
    (
        "unclassified-except",
        "{pkg}/obs/shadow.py",
        """
def pump(sampler):
    try:
        return sampler.score()
    except Exception as e:
        return {"error": repr(e)[:200]}
""",
        """
from {pkg}.resilience import classify

def pump(sampler):
    try:
        return sampler.score()
    except Exception as e:
        return {"error": repr(e)[:200], "kind": classify(e)}
""",
    ),
    (
        "obs-coverage",
        "{pkg}/obs/flight.py",
        """
def extract_frontier(records):
    return {"points": 0}
""",
        """
from {pkg} import obs

class FlightRecorder:
    def sample(self, now=None):
        with obs.record_span("obs.flight::sample"):
            return {}

    def maybe_sample(self, now=None):
        return None

def extract_frontier(records):
    with obs.record_span("obs.flight::frontier"):
        return {"points": 0}

def render(records):
    with obs.record_span("obs.flight::render"):
        return ""

def read_recording(path):
    return []

def validate(records):
    return []
""",
    ),
    (
        "span-name",
        "{pkg}/obs/flight.py",
        """
from {pkg} import obs

def sample(window):
    with obs.record_span("Flight Window Sample"):
        return {}
""",
        """
from {pkg} import obs

def sample(window):
    with obs.record_span("obs.flight::sample"):
        return {}

def extract_frontier(records):
    with obs.record_span("obs.flight::frontier"):
        return {}
""",
    ),
    # two serving threads bump an annotated counter with no lock
    (
        "guarded-state",
        "{pkg}/serving/window.py",
        """
import threading

class Window:
    def __init__(self):
        self._lock = threading.Lock()
        self._hits = 0  # guarded-by: _lock

    def record(self):
        self._hits += 1

    def run(self):
        workers = [threading.Thread(target=self.record) for _ in range(2)]
        for t in workers:
            t.start()
        for t in workers:
            t.join()
""",
        """
import threading

class Window:
    def __init__(self):
        self._lock = threading.Lock()
        self._hits = 0       # guarded-by: _lock
        self._last = 0.0     # guarded-by: _lock, reads-ok

    def record(self, now):
        with self._lock:
            self._hits += 1
            self._last = now

    def last_seen(self):
        return self._last

    def run(self):
        workers = [threading.Thread(target=self.record, args=(1.0,))
                   for _ in range(2)]
        for t in workers:
            t.start()
        for t in workers:
            t.join()
""",
    ),
    # the two-lock cycle: transfer takes A then B while audit takes B then A
    (
        "lock-order",
        "{pkg}/serving/ledger.py",
        """
import threading

_ACCOUNTS = threading.Lock()
_AUDIT = threading.Lock()

def transfer(ledger, rec):
    with _ACCOUNTS:
        with _AUDIT:
            ledger.append(rec)

def audit(ledger):
    with _AUDIT:
        with _ACCOUNTS:
            return list(ledger)
""",
        """
import threading

_ACCOUNTS = threading.Lock()
_AUDIT = threading.Lock()

def transfer(ledger, rec):
    with _ACCOUNTS:
        with _AUDIT:
            ledger.append(rec)

def audit(ledger):
    with _ACCOUNTS:
        with _AUDIT:
            return list(ledger)
""",
    ),
]

# ---------------------------------------------------------------------------
# torch fixtures for the four recast ids
# ---------------------------------------------------------------------------

_LAUNCHER = """
import numpy as np
import torch
from raft_tpu_torch.ops import _native

SCAN_KERNEL = _native.KernelCounter("scan")


def _launch(x, alpha, host, a):
    y = torch.relu(x)
    mask = y > 0
{body}
    SCAN_KERNEL.launches += 1
    return y
"""

TORCH_FIXTURES = [
    (
        "tensor-branch",
        "mod.py",
        _LAUNCHER.format(body="    if mask.any():\n        y = y + 1"),
        # near-miss: structure/metadata probes in the launch region, and a
        # host function (no launch, no @traced loop) branching on a tensor
        _LAUNCHER.format(body=(
            "    if x is None or x.shape[0] == 0 or len(x) == 0:\n"
            "        y = y + 1\n"
            "    if x.dtype == torch.float32 and x.device.type == 'cuda':\n"
            "        y = y * 2"))
        + """

def summarize(t):
    if (t > 0).any():
        return 1
    return 0
""",
    ),
    (
        "tensor-branch",
        "mod.py",
        """
import torch
from raft_tpu_torch.core.trace import traced


@traced("mod::search")
def search(q, tiles):
    out = []
    for t in tiles:
        d = torch.cdist(q, t)
        if d.min() < 0:
            d = d.clamp_min(0)
        out.append(d)
    return out
""",
        # near-miss: the branch sits behind obs.enabled(), or reads a host
        # value; the loop's own iterable runs once
        """
import torch
from raft_tpu_torch import obs
from raft_tpu_torch.core.trace import traced


@traced("mod::search")
def search(q, tiles):
    out = []
    for t in tiles:
        d = torch.cdist(q, t)
        if obs.enabled():
            if d.min() < 0:
                obs.add("mod.negative", 1)
        if len(out) > 3 or d.shape[0] == 0:
            break
        out.append(d)
    return out
""",
    ),
    (
        "tensor-branch",
        "mod.py",
        """
import torch


@torch.compile
def f(x):
    if x.sum() > 0:
        return x
    return -x
""",
        """
import torch


@torch.compile
def f(x, w=None):
    if w is None:
        w = torch.ones_like(x)
    if x.dtype == torch.int32:
        x = x.float()
    return torch.where(x.sum() > 0, x, -x) * w
""",
    ),
    (
        "tensor-branch",
        "mod.py",
        """
import torch
from raft_tpu_torch.core.trace import traced


@traced("mod::fit")
def fit(x, tol):
    err = torch.linalg.norm(x)
    while err > tol:
        x = x / 2
        err = torch.linalg.norm(x)
    return x
""",
        """
import torch
from raft_tpu_torch.core.trace import traced


@traced("mod::fit")
def fit(x, tol, steps):
    it = 0
    while it < steps:
        x = x / 2
        it += 1
    return x
""",
    ),
    (
        "launch-host-sync",
        "mod.py",
        _LAUNCHER.format(body="    n = int(y.sum())"),
        _LAUNCHER.format(body="    n = int(x.shape[0] * alpha)"),
    ),
    (
        "loop-host-transfer",
        "mod.py",
        """
import torch
from raft_tpu_torch.core.trace import traced


@traced("mod::build")
def build(parts):
    out = []
    for p in parts:
        out.append(torch.relu(p).sum().item())
    return out
""",
        # near-miss: the sync is gated behind obs.enabled()
        """
import torch
from raft_tpu_torch import obs
from raft_tpu_torch.core.trace import traced


@traced("mod::build")
def build(parts):
    out = []
    for p in parts:
        out.append(torch.relu(p))
        if obs.enabled():
            obs.add("mod.rows", int(p.sum()))
    return out
""",
    ),
    (
        "loop-host-transfer",
        "mod.py",
        """
import torch
from raft_tpu_torch.core.trace import traced


def _sync(t):
    return float(torch.relu(t).max())


@traced("mod::build")
def build(parts):
    for p in parts:
        _sync(p)
    return parts
""",
        # near-miss: a helper that returns at once with telemetry off, and
        # a for loop whose iterable (read once) is the host copy
        """
import torch
from raft_tpu_torch import obs
from raft_tpu_torch.core.trace import traced


def _sync(t):
    if not obs.enabled():
        return None
    return float(torch.relu(t).max())


@traced("mod::build")
def build(parts, x):
    total = 0.0
    for v in x.sum(0).tolist():
        total += v
    for p in parts:
        _sync(p)
    return total
""",
    ),
    (
        "recompile-hazard",
        "mod.py",
        """
import torch


def run(fns, x):
    for f in fns:
        x = torch.compile(f)(x)
    return x
""",
        # near-miss: the compile hoisted to module level
        """
import torch


def _impl(x):
    return x * 2


_compiled = torch.compile(_impl)


def run(x):
    return _compiled(x)
""",
    ),
    (
        "recompile-hazard",
        "mod.py",
        _LAUNCHER.format(body="    msg = f'max {y.max()}'"),
        # near-miss: shapes and dtypes read metadata; the same f-string in
        # host code is a host concern
        _LAUNCHER.format(body="    msg = f'{y.shape} {y.dtype} {alpha}'")
        + """

def describe(t):
    return f"max {t.max()}"
""",
    ),
]

def _fill(text, pkg):
    return text.replace("{pkg}", pkg)


FIXTURES = [(rule, _fill(rel, "raft_tpu_torch"), _fill(pos, "raft_tpu_torch"),
             _fill(neg, "raft_tpu_torch"))
            for rule, rel, pos, neg in GENERIC_FIXTURES] + TORCH_FIXTURES


def _run_fixture(tmp_path, relpath, source):
    target = tmp_path / relpath
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(source)
    return analyze_paths([target], root=tmp_path)


def _write_tree(root, files):
    targets = []
    for relpath, source in files.items():
        target = root / relpath
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_text(source)
        if relpath.endswith(".py"):
            targets.append(target)
    return targets


def _run_tree(tmp_path, files):
    """Multi-file fixture runner for the interprocedural rules (non-.py
    entries — a fixture README — shape the tree only)."""
    return analyze_paths(_write_tree(tmp_path, files), root=tmp_path)


@pytest.mark.parametrize(
    "rule_id,relpath,positive,negative", FIXTURES,
    ids=[f"{f[0]}-{i}" for i, f in enumerate(FIXTURES)])
def test_rule_fixtures(tmp_path, rule_id, relpath, positive, negative):
    get_rule(rule_id)  # rule must exist in the registry
    hits = _run_fixture(tmp_path / "pos", relpath, positive)
    assert any(f.rule == rule_id for f in hits), \
        f"{rule_id}: triggering fixture produced {hits!r}"
    misses = _run_fixture(tmp_path / "neg", relpath, negative)
    assert not any(f.rule == rule_id for f in misses), \
        f"{rule_id}: near-miss fixture wrongly produced " \
        f"{[f for f in misses if f.rule == rule_id]!r}"


def test_catalog_is_sixteen_ids_with_the_jax_idiom_ones_recast():
    import raft_tpu.analysis as jax_analysis

    ids = {r.id for r in all_rules()}
    jax_ids = {r.id for r in jax_analysis.all_rules()}
    assert len(ids) == 16 and len(jax_ids) == 16
    assert GENERIC_IDS <= ids and GENERIC_IDS <= jax_ids
    assert ids == GENERIC_IDS | set(RECAST.values())
    assert jax_ids == GENERIC_IDS | set(RECAST)
    # every rule module keeps its JAX file name
    names = sorted(p.name for p in
                   (REPO / "raft_tpu_torch/analysis/rules").glob("*.py"))
    assert names == sorted(p.name for p in
                           (REPO / "raft_tpu/analysis/rules").glob("*.py"))


# ---------------------------------------------------------------------------
# the sync predicate, one line at a time inside a launch region
# ---------------------------------------------------------------------------

SYNC_LINES = [
    ("v = y.max().item()", True),
    ("h = y.tolist()", True),
    ("h = y.cpu()", True),
    ("h = y.numpy()", True),
    ("h = y.to('cpu')", True),
    ("n = int(y.sum())", True),
    ("s = float(y.mean())", True),
    ("idx = torch.nonzero(mask)", True),
    ("idx = mask.nonzero()", True),
    ("idx = torch.where(mask)", True),
    ("sel = torch.masked_select(y, mask)", True),
    ("sel = y[mask]", True),
    ("sel = y[y > 0]", True),
    ("sel = y[torch.isfinite(y) & ~mask]", True),
    ("torch.cuda.synchronize()", True),
    ("arr = np.asarray(y)", True),
    ("t = torch.tensor([1, 2, 3], device=x.device)", True),
    ("t = torch.from_numpy(a).to(x.device)", True),
    ("t = torch.tensor([1, 2]).to(x.device)", True),
    # near-misses: metadata, host scalars, non-blocking or host-side work
    ("n = int(x.shape[0])", False),
    ("s = float(alpha)", False),
    ("m = len(x) + y.numel() + y.size(0) + y.dim()", False),
    ("p = y.data_ptr()", False),
    ("dt = (y.dtype, y.device, y.ndim)", False),
    ("t = torch.tensor([1, 2, 3], device='cpu')", False),
    ("t = torch.from_numpy(a).to(x.device, non_blocking=True)", False),
    ("t = torch.tensor([1, 2]).to(x.device, non_blocking=True)", False),
    ("t = y.to(x.device)", False),
    ("arr = np.asarray(host)", False),
    ("h = np.asarray(host).tolist()", False),
    ("z = torch.where(mask, y, 0.0)", False),
    ("w = y * mask", False),
    ("y[mask] = 0.0", False),
]


@pytest.mark.parametrize("line,syncs", SYNC_LINES,
                         ids=[s[0] for s in SYNC_LINES])
def test_launch_host_sync_predicate(tmp_path, line, syncs):
    """Each line inside a kernel launcher: a sync is ``launch-host-sync``;
    the same line in host code outside any launch region is not."""
    src = _LAUNCHER.format(body="    " + line)
    hits = [f for f in _run_fixture(tmp_path / "in", "mod.py", src)
            if f.rule == "launch-host-sync"]
    assert bool(hits) == syncs, hits
    host = src.replace("    SCAN_KERNEL.launches += 1\n", "")
    assert not [f for f in _run_fixture(tmp_path / "out", "mod.py", host)
                if f.rule == "launch-host-sync"]


def test_launch_regions_close_over_callees_and_captures(tmp_path):
    """Roots: ``_native`` launchers, kernel-counter sites, torch.compile /
    torch.jit targets and CUDA graph captures; a same-module callee of a
    root is in the region, a caller of one is not, and a generic
    ``executor.map`` callback is not."""
    src = '''
import torch
from raft_tpu_torch.ops import _native

SCAN_KERNEL = _native.KernelCounter("scan")


def _kernel_fn():
    return _native.load("scan").raft_scan


def _check(t):
    return int(t.sum())


def wrapper(x):
    _check(x)
    rc = _kernel_fn()(x)
    SCAN_KERNEL.launches += 1
    return rc


def caller(x):
    n = int(x.sum())
    return wrapper(x), n


def body(x):
    return x.nonzero()


def capture(g, x):
    with torch.cuda.graph(g):
        y = body(x)
    return y


def scripted(x):
    return x.tolist()


_s = torch.jit.script(scripted)


def pool(executor, items):
    def worker(t):
        return t.cpu()
    return list(executor.map(worker, items))
'''
    (tmp_path / "m.py").write_text(src)
    hits = analyze_paths([tmp_path / "m.py"], root=tmp_path)
    lines = {f.line for f in hits if f.rule == "launch-host-sync"}
    text = src.splitlines()
    where = {text[n - 1].strip() for n in lines}
    assert where == {"return int(t.sum())", "return x.nonzero()",
                     "return x.tolist()"}, where


def test_tuple_unpacking_reads_the_local_callee_returns(tmp_path):
    """``a, n = f(...)`` taints ``a`` alone when ``f`` (same module)
    returns a tensor and a host int there: branching on ``n`` in a traced
    loop is host work (the JAX package baselines this imprecision)."""
    src = '''
import torch
from raft_tpu_torch.core.trace import traced


def _round(x):
    y = torch.relu(x)
    return y, 3


@traced("mod::build")
def build(x):
    for _ in range(4):
        x, n = _round(x)
        if n <= 0:
            break
        if x.sum() <= 0:
            break
    return x
'''
    (tmp_path / "m.py").write_text(src)
    hits = [f for f in analyze_paths([tmp_path / "m.py"], root=tmp_path)
            if f.rule == "tensor-branch"]
    assert [src.splitlines()[f.line - 1].strip() for f in hits] == [
        "if x.sum() <= 0:"]


def test_out_of_core_host_slices_are_not_syncs(tmp_path):
    """The port's counterpart of the JAX package's batch_knn entry: a
    numpy conversion of a host array's slice in a @traced loop is host
    work (the JAX rule flags any ``np.asarray``); the upload of that chunk
    is the copy the rule reports."""
    src = '''
import numpy as np
import torch
from raft_tpu_torch.core.trace import traced


@traced("mod::search_out_of_core")
def search(dataset, chunk_rows, dev):
    out = []
    for s in range(0, dataset.shape[0], chunk_rows):
        host_chunk = np.ascontiguousarray(np.asarray(
            dataset[s:s + chunk_rows], dtype=np.float32))
        out.append(torch.from_numpy(host_chunk).to(dev))
    return out
'''
    (tmp_path / "m.py").write_text(src)
    hits = [f for f in analyze_paths([tmp_path / "m.py"], root=tmp_path)
            if f.rule == "loop-host-transfer"]
    assert [f.line for f in hits] == [13], hits
    assert "torch.from_numpy" in hits[0].message


# ---------------------------------------------------------------------------
# the interprocedural rules (multi-file trees)
# ---------------------------------------------------------------------------


def test_faultpoint_contract_both_directions(tmp_path):
    lib = """
from raft_tpu_torch import resilience

def drain(batch):
    resilience.faultpoint("pump.drain")
    return list(batch)
"""
    armed = """
from raft_tpu_torch import resilience

def test_drain_recovers():
    resilience.arm_faults("pump.drain=transient:1")
"""
    bystander = """
def test_unrelated():
    assert True
"""
    hits = _run_tree(tmp_path / "unarmed", {
        "raft_tpu_torch/serving/pump.py": lib,
        "tests/test_pump.py": bystander,
    })
    hits = [f for f in hits if f.rule == "faultpoint-contract"]
    assert len(hits) == 1 and "pump.drain" in hits[0].message, hits
    assert hits[0].path.endswith("pump.py")

    stale = _run_tree(tmp_path / "stale", {
        "raft_tpu_torch/serving/pump.py":
            "def drain(batch):\n    return list(batch)\n",
        "tests/test_pump.py": armed,
    })
    stale = [f for f in stale if f.rule == "faultpoint-contract"]
    assert len(stale) == 1 and stale[0].path.endswith("test_pump.py"), stale

    misses = _run_tree(tmp_path / "armed", {
        "raft_tpu_torch/serving/pump.py": lib,
        "tests/test_pump.py": armed,
    })
    assert not any(f.rule == "faultpoint-contract" for f in misses), misses


def test_faultpoint_sites_through_a_helper_and_kind_holes(tmp_path):
    """A literal site handed to a helper that calls ``faultpoint(param)``
    is a site (``_filter_plan("ivf_pq.search.filter", ...)``), found in
    the same module or through an import; an f-string arming spec whose
    kind is a hole (``f"site={fault}:1"``) arms its site."""
    plan = """
from raft_tpu_torch.resilience import faultpoint

def _plan(site, n):
    faultpoint(site)
    return n

def search(q):
    return _plan("pump.search.filter", q)
"""
    other = """
from raft_tpu_torch.serving.plan import _plan

def search(q):
    return _plan("pump.other.filter", q)
"""
    tests = """
import pytest

@pytest.mark.parametrize("fault", ["oom", "fatal"])
def test_filter_faults(res, fault):
    res.arm_faults(f"pump.search.filter={fault}:1")
    res.arm_faults(f"pump.other.filter={fault}:1")
"""
    tree = {"raft_tpu_torch/serving/plan.py": plan,
            "raft_tpu_torch/serving/other.py": other,
            "tests/test_plan.py": tests}
    assert not [f for f in _run_tree(tmp_path / "armed", tree)
                if f.rule == "faultpoint-contract"]
    tree["tests/test_plan.py"] = tests.replace("pump.other", "pump.gone")
    hits = [f for f in _run_tree(tmp_path / "half", tree)
            if f.rule == "faultpoint-contract"]
    assert sorted((f.path, f.line) for f in hits) == [
        ("raft_tpu_torch/serving/other.py", 5),
        ("tests/test_plan.py", 7)], hits


def test_env_knob_double_default(tmp_path):
    registered = """
import os

def cap():
    return int(os.environ.get("RAFT_TPU_FIX_CAP", "8"))
"""
    twin = """
import os

def cap():
    return int(os.getenv("RAFT_TPU_FIX_CAP", "8"))
"""
    hits = _run_tree(tmp_path / "pos", {
        "raft_tpu_torch/alpha.py": registered,
        "raft_tpu_torch/beta.py": twin,
    })
    drift = [f for f in hits if f.rule == "env-knob"]
    assert drift and all("more than one" in f.message for f in drift), hits

    misses = _run_tree(tmp_path / "neg", {
        "raft_tpu_torch/alpha.py": registered,
        "raft_tpu_torch/beta.py": (
            "from raft_tpu_torch.alpha import cap\n\n\n"
            "def twice():\n    return 2 * cap()\n"),
    })
    assert not any(f.rule == "env-knob" for f in misses), misses


def test_env_knob_readme_documentation(tmp_path):
    src = """
import os

def cap():
    return int(os.environ.get("RAFT_TPU_FIX_CAP", "8"))
"""
    table_without = "| `RAFT_TPU_OTHER` | `1` | some other knob |\n"
    table_with = table_without + \
        "| `RAFT_TPU_FIX_CAP` | `8` | fixture capacity knob |\n"
    hits = _run_tree(tmp_path / "pos", {
        "raft_tpu_torch/alpha.py": src,
        "README.md": table_without,
    })
    undoc = [f for f in hits if f.rule == "env-knob"]
    assert len(undoc) == 1 and "no README knob-table row" in undoc[0].message, \
        hits
    misses = _run_tree(tmp_path / "neg", {
        "raft_tpu_torch/alpha.py": src,
        "README.md": table_with,
    })
    assert not any(f.rule == "env-knob" for f in misses), misses


def test_guarded_state_lock_graph_dump(tmp_path):
    src = """
import threading

_A = threading.Lock()
_B = threading.Lock()

def forward(items):
    with _A:
        with _B:
            return list(items)

def backward(items):
    with _B:
        with _A:
            return list(items)
"""
    mod = tmp_path / "m.py"
    mod.write_text(src)
    out = tmp_path / "lock_graph.json"
    rc = cli_main([str(mod), "--root", str(tmp_path),
                   "--select", "lock-order", "--graph", str(out)])
    assert rc == 1  # the cycle is a finding AND the artifact still lands
    data = json.loads(out.read_text())
    locks = {n for e in data["edges"] for n in (e["held"], e["taken"])}
    assert {"m.py::_A", "m.py::_B"} <= locks, data
    assert data["cycles"], data


# ---------------------------------------------------------------------------
# parity: the twelve generic ids against the JAX package's rules
# ---------------------------------------------------------------------------

_PARITY_EXTRA = {
    "{pkg}/serving/pump.py": """
from {pkg} import resilience

def drain(batch):
    resilience.faultpoint("pump.drain")
    resilience.faultpoint("pump.fill")
    return list(batch)
""",
    "tests/test_pump.py": """
from {pkg} import resilience

def test_drain_recovers():
    resilience.arm_faults("pump.drain=transient:1")
    resilience.arm_faults("pump.stale=fatal:1")
""",
    "{pkg}/alpha.py": """
import os

def cap():
    return int(os.environ.get("RAFT_TPU_FIX_CAP", "8"))
""",
    "{pkg}/beta.py": """
import os

def cap():
    return int(os.getenv("RAFT_TPU_FIX_CAP", "8"))

def other():
    return os.environ.get("RAFT_TPU_FIX_OTHER")
""",
    "README.md": "| `RAFT_TPU_FIX_CAP` | `8` | fixture capacity knob |\n",
}


def _parity_files(pkg):
    """Every generic fixture (both halves) at its own path, plus the
    multi-file contract cases, under package ``pkg``."""
    files = {}
    for i, (_, rel, pos, neg) in enumerate(GENERIC_FIXTURES):
        for half, src in (("p", pos), ("n", neg)):
            head, _, name = _fill(rel, pkg).rpartition("/")
            files[f"{head}/c{i}{half}/{name}".lstrip("/")] = _fill(src, pkg)
    for rel, src in _PARITY_EXTRA.items():
        files[_fill(rel, pkg)] = _fill(src, pkg)
    return files


def test_generic_rules_equal_the_jax_rules_on_one_fixture_tree(tmp_path):
    """The fixture tree holds no jax and no torch calls; the JAX tree is
    the same files under ``raft_tpu/``. Both scans give one
    ``(path, line, rule)`` set, and every generic id fires in it."""
    port = _write_tree(tmp_path / "port", _parity_files("raft_tpu_torch"))
    jax = _write_tree(tmp_path / "jax", _parity_files("raft_tpu"))
    got = {(f.path.replace("raft_tpu_torch/", "raft_tpu/"), f.line, f.rule)
           for f in analyze_paths(port, root=tmp_path / "port")
           if f.rule in GENERIC_IDS}
    want = {(f.path, f.line, f.rule)
            for f in jax_analyze_paths(jax, root=tmp_path / "jax")
            if f.rule in GENERIC_IDS}
    assert got == want, (sorted(got - want), sorted(want - got))
    assert {rule for _, _, rule in got} == GENERIC_IDS


def test_one_suppression_comment_silences_both_tools(tmp_path):
    src = "def f(x, acc=[]):  # graftlint: ignore[mutable-default]\n" \
          "    return acc\n"
    (tmp_path / "m.py").write_text(src)
    assert analyze_paths([tmp_path / "m.py"], root=tmp_path) == []
    assert jax_analyze_paths([tmp_path / "m.py"], root=tmp_path) == []


def test_parse_error_is_a_finding_not_a_crash(tmp_path):
    (tmp_path / "bad.py").write_text("def f(:\n")
    findings = analyze_paths([tmp_path / "bad.py"], root=tmp_path)
    assert [f.rule for f in findings] == ["parse-error"]


# ---------------------------------------------------------------------------
# baseline round-trip, formats, the CLI
# ---------------------------------------------------------------------------


def test_baseline_round_trip(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text("def f(x, acc=[]):\n    return acc\n")
    found = analyze_paths([mod], root=tmp_path)
    assert [f.rule for f in found] == ["mutable-default"]

    bl_path = tmp_path / "baseline.json"
    Baseline.from_findings(found).save(bl_path)
    bl = Baseline.load(bl_path)
    new, absorbed = bl.filter(analyze_paths([mod], root=tmp_path))
    assert new == [] and absorbed == 1
    data = json.loads(bl_path.read_text())
    assert set(data["entries"][0]) == {"rule", "path", "snippet", "count",
                                       "severity", "justification"}

    mod.write_text("import os\n\n\ndef f(x, acc=[]):\n    return acc\n")
    new, _ = bl.filter(analyze_paths([mod], root=tmp_path))
    assert [f.rule for f in new] == ["unused-import"]

    mod.write_text(
        "def f(x, acc=[]):\n    return acc\n\n\n"
        "def g(x, acc=[]):\n    return acc\n")
    new, absorbed = bl.filter(analyze_paths([mod], root=tmp_path))
    assert absorbed == 1 and [f.rule for f in new] == ["mutable-default"]

    bl.entries[0]["justification"] = "legacy accumulator"
    bl.save(bl_path)
    regen = Baseline.from_findings(
        analyze_paths([mod], root=tmp_path), previous=Baseline.load(bl_path))
    assert len(regen.entries) == 2
    assert len([e for e in regen.entries
                if e["justification"] == "legacy accumulator"]) == 1
    assert len(regen.todo_entries()) == 1


def test_report_formats():
    from raft_tpu_torch.analysis.findings import Finding

    f = Finding(path="a.py", line=3, rule="r", severity="error", message="m",
                snippet="x = 1")
    text = format_text([f], baselined=2)
    assert "a.py:3 · r · error · m" in text
    assert "1 new finding" in text and "2 baselined" in text
    data = json.loads(format_json([f], baselined=2))
    assert data["findings"][0]["line"] == 3 and data["baselined"] == 2


def test_cli_exit_codes_and_list_rules(tmp_path, capsys):
    mod = tmp_path / "m.py"
    mod.write_text("def f(x, acc=[]):\n    return acc\n")
    ok = tmp_path / "ok.py"
    ok.write_text("X = 1\n")
    assert cli_main([str(ok), "--root", str(tmp_path)]) == 0
    assert cli_main([str(mod), "--root", str(tmp_path)]) == 1
    capsys.readouterr()
    assert cli_main([str(mod), "--root", str(tmp_path), "--json"]) == 1
    assert json.loads(capsys.readouterr().out)["new"] == 1
    assert cli_main([str(mod), "--root", str(tmp_path), "--no-baseline",
                     "--rule", "mutable-default"]) == 1
    assert cli_main([str(mod), "--root", str(tmp_path),
                     "--select", "not-a-rule"]) == 2
    assert cli_main([str(tmp_path / "nope.pyy"), "--root", str(tmp_path)]) == 2
    assert cli_main([str(mod), "--root", str(tmp_path),
                     "--select", "mutable-default", "--write-baseline"]) == 2
    assert cli_main([]) == 2
    capsys.readouterr()
    assert cli_main(["--list-rules"]) == 0
    listed = [line.split()[0] for line in
              capsys.readouterr().out.strip().splitlines()]
    assert len(listed) == 16
    assert set(listed) == GENERIC_IDS | set(RECAST.values())


def test_write_baseline_refuses_partial_scope(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "a.py").write_text("def f(x, acc=[]):\n    return acc\n")
    other = tmp_path / "other.py"
    other.write_text("def g(x, acc=[]):\n    return acc\n")
    bl_path = tmp_path / "raft_tpu_torch" / "analysis" / "baseline.json"
    assert cli_main([str(pkg), str(other), "--root", str(tmp_path),
                     "--write-baseline"]) == 0
    before = bl_path.read_text()
    assert cli_main([str(pkg), "--root", str(tmp_path),
                     "--write-baseline"]) == 2
    assert bl_path.read_text() == before
    other.unlink()
    assert cli_main([str(pkg), "--root", str(tmp_path),
                     "--write-baseline"]) == 0


# ---------------------------------------------------------------------------
# the repo gate: the port is clean against its own baseline
# ---------------------------------------------------------------------------


def test_repo_is_clean_against_the_ports_baseline():
    t0 = time.monotonic()
    findings = analyze_paths(scan_paths(REPO), root=REPO)
    elapsed = time.monotonic() - t0
    new, absorbed = Baseline.load(DEFAULT_PATH).filter(findings)
    assert new == [], (
        "graftlint found NEW findings in the port (fix them or — "
        "deliberately — regenerate via python -m "
        "raft_tpu_torch.analysis.write_baseline):\n" + format_text(new))
    assert absorbed == sum(e["count"] for e in
                           Baseline.load(DEFAULT_PATH).entries)
    assert elapsed < 30, f"analysis took {elapsed:.1f}s (budget: 30s CPU)"


def test_ports_baseline_entries_all_justified():
    bl = Baseline.load(DEFAULT_PATH)
    assert bl.entries, "the port's baseline should exist"
    assert not bl.todo_entries(), bl.todo_entries()
    assert all(e["justification"].strip() for e in bl.entries)
    assert DEFAULT_PATH == REPO / "raft_tpu_torch/analysis/baseline.json"
    toml = (REPO / "pyproject.toml").read_text()
    assert '"raft_tpu_torch.analysis" = ["baseline.json"]' in toml


def test_gate_child_exits_clean_without_cuda_or_jax():
    """``python -m raft_tpu_torch.analysis <scan set>`` in a child whose
    CUDA lazy init raises (``chip_smoke.py``'s analysis child, which the
    card runs too): exit 0, and at exit no CUDA context, no jax and no JAX
    package in ``sys.modules``."""
    from chip_smoke import ANALYSIS_CHILD

    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", ANALYSIS_CHILD,
                          *scan_paths(REPO)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    elapsed = time.monotonic() - t0
    assert out.returncode == 0, out.stdout + out.stderr
    assert "graftlint: 0 new findings" in out.stdout
    status = json.loads(out.stderr.strip().splitlines()[-1])
    assert status == {"cuda": False, "jax": []}, status
    assert elapsed < 60, elapsed


def test_every_jax_module_has_a_port_counterpart_but_three():
    """Queue 1 is closed: comparing the packages' file lists leaves only
    the three JAX files that exist for jax, XLA or the TPU plugin."""
    def files(pkg):
        return {p.relative_to(REPO / pkg).as_posix()
                for p in (REPO / pkg).rglob("*.py")
                if "__pycache__" not in p.parts}

    missing = files("raft_tpu") - files("raft_tpu_torch")
    assert missing == {"core/compat.py", "utils/compile_cache.py",
                       "utils/subproc.py"}, missing
