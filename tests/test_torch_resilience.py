"""Port parity: raft_tpu_torch's resilience core (errors, retry,
faultinject, deadline, shard_health, interruptible, fsio, logger,
resources scoping, utils/tiling) against raft_tpu's on the same inputs.

Each test drives both packages with the same sequence and compares what
they decide: the failure kind of one table of exceptions (plus the card's
and the kernel builds' rows, which only the port meets), the backoff
schedule of a seeded policy, the parse of the fault grammar, the sizes
``degrade_on_oom`` steps through under an injected OOM, deadline scopes,
shard-health transitions, and the tiled map's result. The two packages
keep separate state (registry, event ring, fault table), so every test
resets both.
"""

import logging
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu import resilience as jres
from raft_tpu.core import interruptible as jint
from raft_tpu.core import logger as jlog
from raft_tpu.resilience import faultinject as jfi
from raft_tpu.utils import tiling as jtil
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import resilience as tres
from raft_tpu_torch.core import fsio
from raft_tpu_torch.core import interruptible as tint
from raft_tpu_torch.core import logger as tlog
from raft_tpu_torch.core import serialize as tser
from raft_tpu_torch.core.resources import (Resources, current_resources,
                                           resolve_device, use_resources)
from raft_tpu_torch.ops import _native
from raft_tpu_torch.resilience import faultinject as tfi
from raft_tpu_torch.utils import tiling as ttil

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean_state():
    for res, ob in ((jres, jobs), (tres, tobs)):
        res.clear_faults()
        res.clear_events()
        ob.reset()
    yield
    for res, ob in ((jres, jobs), (tres, tobs)):
        res.clear_faults()
        res.clear_events()
        ob.disable()
        ob.reset()


# ---------------------------------------------------------------------------
# classify
# ---------------------------------------------------------------------------


def _wrapped(inner, outer_msg="wrapper"):
    try:
        raise inner
    except Exception as e:
        try:
            raise RuntimeError(outer_msg) from e
        except RuntimeError as w:
            return w


def _shared_exceptions(pkg_int):
    """The same table for both packages (``pkg_int`` supplies the
    package's own InterruptedException)."""
    return [
        RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating 8G"),
        MemoryError(),
        RuntimeError("failed to allocate 3.2GiB HBM"),
        subprocess.TimeoutExpired("cmd", 5),
        TimeoutError("op timed out"),
        RuntimeError("DEADLINE_EXCEEDED: rpc"),
        ConnectionResetError("peer reset"),
        InterruptedError("EINTR"),
        RuntimeError("UNAVAILABLE: socket closed"),
        RuntimeError("ABORTED: transaction"),
        ValueError("shape mismatch (3, 4) vs (4, 3)"),
        KeyError("x"),
        pkg_int.InterruptedException("cancelled"),
        _wrapped(RuntimeError("RESOURCE_EXHAUSTED: deep")),
        _wrapped(ConnectionRefusedError("nope")),
        _wrapped(ValueError("plain bug")),
    ]


def test_classify_table_matches_jax():
    jk = [jres.classify(e) for e in _shared_exceptions(jint)]
    tk = [tres.classify(e) for e in _shared_exceptions(tint)]
    assert tk == jk
    assert set(tk) == set(tres.KINDS)


def test_classify_implicit_context_stays_fatal_in_both():
    def raise_in_handler(res):
        try:
            try:
                raise MemoryError()
            except MemoryError:
                raise ValueError("bug while handling")
        except ValueError as e:
            return res.classify(e)

    assert raise_in_handler(jres) == raise_in_handler(tres) == tres.FATAL


@pytest.mark.parametrize("exc,kind", [
    (torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 38.15 GiB. GPU 0 has a total "
        "capacity of 79.10 GiB"), tres.OOM),
    (torch.OutOfMemoryError("CUDA out of memory."), tres.OOM),
    (RuntimeError("CUDA error: out of memory\nCUDA kernel errors might be "
                  "asynchronously reported"), tres.OOM),
    (RuntimeError(_native.launch_message("strip_scan", 2)), tres.OOM),
    (RuntimeError(_native.launch_message("cagra_hop", 1)), tres.FATAL),
    (RuntimeError(_native.launch_message("pq_scan", 209)), tres.FATAL),
    (_native.NativeBuildError("kernel build failed:\nstrip_scan.cu: nvcc "
                              "exit 1\nresource temporarily unavailable"),
     tres.FATAL),
    (_native.NativeBuildError("nvcc: out of memory; try again"), tres.FATAL),
    (_native.NativeBuildError("nvcc not found: the CUDA kernels are built on "
                              "the machine with the card"), tres.FATAL),
    (_wrapped(_native.NativeBuildError("connection reset while compiling"),
              "kernel path failed"), tres.FATAL),
    (_wrapped(torch.cuda.OutOfMemoryError("CUDA out of memory.")), tres.OOM),
])
def test_classify_card_and_native_rows(exc, kind):
    assert tres.classify(exc) == kind


def test_oom_messages_match_the_jax_patterns():
    """The card's OOM texts classify OOM by message alone in the JAX
    package's table too (its ``_OOM_PATTERNS``), so the port adds no
    pattern for them."""
    for msg in ("CUDA out of memory. Tried to allocate 2.00 GiB",
                "CUDA error: out of memory",
                _native.launch_message("bq_scan", 2)):
        assert jres.classify(RuntimeError(msg)) == jres.OOM
        assert tres.classify(RuntimeError(msg)) == tres.OOM


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
@pytest.mark.parametrize("kw", [
    {}, {"max_retries": 6, "base_delay_s": 0.01, "multiplier": 3.0},
    {"max_retries": 5, "max_delay_s": 0.2, "jitter": 0.5}])
def test_backoff_schedule_matches_jax(seed, kw):
    jd = jres.backoff_delays(jres.RetryPolicy(seed=seed, **kw))
    td = tres.backoff_delays(tres.RetryPolicy(seed=seed, **kw))
    assert td == jd


def _flaky(res, fail_times, msg):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= fail_times:
            raise RuntimeError(msg)
        return len(calls)
    return fn, calls


@pytest.mark.parametrize("fail_times,msg", [
    (2, "UNAVAILABLE: flaky"), (5, "UNAVAILABLE: down"),
    (1, "RESOURCE_EXHAUSTED: oom"), (1, "plain bug")])
def test_with_retries_matches_jax(fail_times, msg):
    outcomes = []
    for res in (jres, tres):
        fn, calls = _flaky(res, fail_times, msg)
        slept = []
        try:
            out = res.with_retries(fn, res.RetryPolicy(max_retries=3, seed=3),
                                   sleep=slept.append)
        except RuntimeError as e:
            out = ("raised", res.classify(e))
        outcomes.append((out, len(calls), slept))
    assert outcomes[1] == outcomes[0]


@pytest.mark.parametrize("size,fits,floor,factor", [
    (1024, 100, 1, 2), (1000, 300, 64, 2), (4096, 4096, 1, 2),
    (800, 10, 128, 2), (729, 20, 1, 3)])
def test_degrade_on_oom_steps_match_jax(size, fits, floor, factor):
    results = []
    for res, fi in ((jres, jfi), (tres, tfi)):
        seen = []

        def fn(s):
            seen.append(s)
            if s > fits:
                raise fi.FaultInjected(f"RESOURCE_EXHAUSTED: size {s}")
            return s

        try:
            out = res.degrade_on_oom(fn, size, floor=floor, factor=factor,
                                     site="t")
        except fi.FaultInjected as e:
            out = ("raised", res.classify(e))
        events = [(e["event"], e["from_size"], e["to_size"])
                  for e in res.recent_events()]
        results.append((out, seen, events))
    assert results[1] == results[0]


def test_degrade_on_oom_counts_and_passes_other_kinds():
    tobs.enable()
    seen = []

    def fn(s):
        seen.append(s)
        if s > 16:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return s

    assert tres.degrade_on_oom(fn, 64, floor=4, site="x") == 16
    assert seen == [64, 32, 16]
    c = tobs.snapshot()["counters"]
    assert c["resilience.retries.oom"] == 2
    assert c["resilience.degraded_tile"] == 2

    def bug(s):
        raise ValueError("not an oom")

    with pytest.raises(ValueError):
        tres.degrade_on_oom(bug, 64, floor=4)


def test_force_completion_and_sync_mode_on_cpu():
    t = (torch.ones(3), [torch.zeros(2), {"a": torch.arange(4)}], 5)
    assert tres.force_completion(t) is t
    tres.enable_sync()
    try:
        assert tres.sync_mode()
        assert tres.degrade_on_oom(lambda s: torch.ones(s), 4).shape == (4,)
    finally:
        tres.disable_sync()
    assert not tres.sync_mode()


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------


# synthetic site names: these tests are of the fault machinery itself
GRAMMAR_SPECS = (
    "a.b=oom",  # graftlint: ignore[faultpoint-contract]
    "a.b=oom:3",  # graftlint: ignore[faultpoint-contract]
    "x=transient:2,y=fatal:1",  # graftlint: ignore[faultpoint-contract]
    "s=delay:1:0.01",  # graftlint: ignore[faultpoint-contract]
    "s=hang:1:2.5",  # graftlint: ignore[faultpoint-contract]
    " p.q = oom:2 , r=delay ",  # graftlint: ignore[faultpoint-contract]
    "z=hang",  # graftlint: ignore[faultpoint-contract]
    "")


@pytest.mark.parametrize("spec", GRAMMAR_SPECS)
def test_fault_grammar_parse_matches_jax(spec):
    jt = {k: (f.kind, f.remaining, f.arg) for k, f in jfi._parse(spec).items()}
    tt = {k: (f.kind, f.remaining, f.arg) for k, f in tfi._parse(spec).items()}
    assert tt == jt


@pytest.mark.parametrize("spec", ["noequals", "=oom", "a=boom", "a=oom:x",
                                  "a= oom : 2"])
def test_fault_grammar_rejects_like_jax(spec):
    with pytest.raises(ValueError):
        jfi._parse(spec)
    with pytest.raises(ValueError):
        tfi._parse(spec)


def test_faultpoint_fires_count_then_passes_and_env(monkeypatch):
    tobs.enable()
    tres.arm_faults("s.one=oom:2,s.two=transient:1")
    kinds = []
    for _ in range(3):
        try:
            tres.faultpoint("s.one")
            kinds.append(None)
        except tres.FaultInjected as e:
            kinds.append(tres.classify(e))
    assert kinds == [tres.OOM, tres.OOM, None]
    assert tres.armed_sites() == {"s.one": ("oom", 0), "s.two": ("transient", 1)}
    assert tobs.snapshot()["counters"]["resilience.faults.oom"] == 2
    monkeypatch.setenv("RAFT_TPU_FAULTS",
                       "env.site=fatal:1")  # graftlint: ignore[faultpoint-contract]
    tfi.reset()
    with pytest.raises(tres.FaultInjected) as ei:
        tres.faultpoint("env.site")
    assert tres.classify(ei.value) == tres.FATAL
    tres.faultpoint("env.site")
    tres.faultpoint("unarmed.site")


def test_hang_fault_ends_at_a_hard_deadline():
    tres.arm_faults("h=hang:1:20")  # graftlint: ignore[faultpoint-contract]
    t0 = time.monotonic()
    with pytest.raises(tres.DeadlineExceeded) as ei:
        with tres.Deadline(0.2):
            tres.faultpoint("h")
    assert time.monotonic() - t0 < 5.0
    assert tres.classify(ei.value) == tres.DEADLINE


# ---------------------------------------------------------------------------
# deadline, interruptible
# ---------------------------------------------------------------------------


def _deadline_trace(res, ints):
    out = []
    with res.Deadline(60.0, label="outer") as outer:
        out.append((res.active_deadline() is outer, outer.reached()))
        with res.Deadline(0.0, hard=False, label="soft") as soft:
            ints.check_interrupt()           # soft: never raises
            out.append((soft.reached(), soft.hard))
            soft.mark_degraded("site.a")
            out.append((soft.degraded, list(soft.degraded_sites)))
        out.append(res.active_deadline() is outer)
        with res.Deadline(0.0, label="hard"):
            try:
                ints.check_interrupt()
                out.append("no raise")
            except res.DeadlineExceeded as e:
                out.append(("raised", res.classify(e)))
    out.append(res.active_deadline() is None)
    return out


def test_deadline_semantics_match_jax():
    assert _deadline_trace(tres, tint) == _deadline_trace(jres, jint)


def test_interrupt_cancel_and_checkpoints():
    tint.cancel()
    with pytest.raises(tint.InterruptedException) as ei:
        tint.check_interrupt()
    assert tres.classify(ei.value) == tres.DEADLINE
    tint.check_interrupt()              # the flag is consumed
    tint.cancel()
    tint.clear()
    tint.check_interrupt()
    other = {}

    def worker():
        other["tid"] = threading.get_ident()

    th = threading.Thread(target=worker)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    tint.cancel(other["tid"])           # another thread's flag
    tint.check_interrupt()
    tint.clear(other["tid"])


# ---------------------------------------------------------------------------
# shard health
# ---------------------------------------------------------------------------


def _shard_sequence(res):
    h = res.ShardHealth(suspect_threshold=2, min_coverage=0.5)
    states = [h.report_failure(0, RuntimeError("UNAVAILABLE: x")),
              h.report_failure(0, MemoryError()),
              h.report_failure(1, ValueError("bug")),
              h.report_failure(2, TimeoutError("slow"))]
    h.report_success(2)
    h.mark_lost(3, "host gone")
    snap = h.snapshot()
    mask = h.serving_mask(5).tolist()
    lost = h.lost()
    h.mark_recovered(1)
    try:
        h.check_quorum(0.25, "ctx")
        quorum = "ok"
    except res.ShardQuorumError as e:
        quorum = res.classify(e)
    return states, snap, mask, lost, h.lost(), quorum


def test_shard_health_matches_jax():
    assert _shard_sequence(tres) == _shard_sequence(jres)
    with pytest.raises(RuntimeError):
        h = tres.ShardHealth()
        h.mark_lost(0)
        h.report_success(0)


def test_shard_health_env_coverage(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_MIN_SHARD_COVERAGE", "0.8")
    tres.reset_shard_health()
    assert tres.shard_health().min_coverage == 0.8
    monkeypatch.setenv("RAFT_TPU_MIN_SHARD_COVERAGE", "junk")
    tres.reset_shard_health()
    assert tres.shard_health().min_coverage == 0.5
    tres.reset_shard_health()


# ---------------------------------------------------------------------------
# tiling, resources scoping
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,tile", [(37, 8), (64, 16), (10, 32), (129, 128)])
def test_map_row_tiles_matches_jax(n, tile):
    # integer values: every sum is exact in fp32, whatever its order
    x = np.random.default_rng(n).integers(-50, 50, (n, 5)).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)

    def jfn(args):
        a, i = args
        return a.sum(axis=1) * 2.0, i + 1

    def tfn(args):
        a, i = args
        return a.sum(dim=1) * 2.0, i + 1

    jv, ji = jtil.map_row_tiles(jfn, (x, ids), tile, fills=(0, -1))
    tv, ti = ttil.map_row_tiles(tfn, (torch.from_numpy(x),
                                      torch.from_numpy(ids)), tile,
                                fills=(0, -1))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ttil.ceil_div(n, tile) == jtil.ceil_div(n, tile)
    tp, nt = ttil.pad_and_tile(torch.from_numpy(x), tile, fill=7)
    jp, jn = jtil.pad_and_tile(x, tile, fill=7)
    assert nt == jn
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_map_row_tiles_degrades_on_oom():
    x = torch.arange(100, dtype=torch.float32)[:, None]
    tiles = []

    def fn(args):
        tiles.append(args[0].shape[0])
        if args[0].shape[0] > 16:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return args[0] * 3

    out = ttil.map_row_tiles(fn, (x,), 64, min_tile=8)
    torch.testing.assert_close(out, x * 3)
    assert tiles[0] == 64 and 32 in tiles and tiles[-1] == 16


def test_use_resources_scopes_the_default():
    assert isinstance(current_resources(), Resources)
    cpu = Resources(device="cpu", workspace_bytes=1 << 20)
    with use_resources(cpu) as r:
        assert current_resources() is r
        assert resolve_device() == torch.device("cpu")
        with use_resources(Resources(device="cpu", workspace_bytes=5)):
            assert current_resources().workspace_bytes == 5
        assert current_resources() is cpu
    assert current_resources() is not cpu


# ---------------------------------------------------------------------------
# fsio, serialize faultpoints, logger
# ---------------------------------------------------------------------------


def test_atomic_write_keeps_the_old_file(tmp_path):
    p = tmp_path / "sub" / "f.bin"
    with fsio.atomic_write(p) as f:
        f.write(b"old")
    with pytest.raises(RuntimeError):
        with fsio.atomic_write(p) as f:
            f.write(b"new-partial")
            raise RuntimeError("crash")
    assert p.read_bytes() == b"old"
    assert sorted(x.name for x in p.parent.iterdir()) == ["f.bin"]
    with pytest.raises(ValueError):
        with fsio.atomic_write(p, "ab"):
            pass

    def producer(tmp):
        with open(tmp, "wb") as f:
            f.write(b"replaced")
    fsio.atomic_replace(p, producer)
    assert p.read_bytes() == b"replaced"


def test_serialize_fault_mid_write_leaves_old_file_whole(tmp_path):
    p = tmp_path / "idx.bin"
    a = {"x": np.arange(10, dtype=np.float32)}
    tser.save_arrays(p, {"kind": "t"}, a)
    before = p.read_bytes()
    tres.arm_faults("serialize.save.write=fatal:1")
    with pytest.raises(tres.FaultInjected) as ei:
        tser.save_arrays(p, {"kind": "t"}, {"x": np.ones(99, np.float32)})
    assert tres.classify(ei.value) == tres.FATAL
    assert p.read_bytes() == before
    assert sorted(x.name for x in tmp_path.iterdir()) == ["idx.bin"]
    tres.arm_faults("serialize.load.read=oom:1")
    with pytest.raises(tres.FaultInjected) as ei:
        tser.load_arrays(p)
    assert tres.classify(ei.value) == tres.OOM
    meta, arrays = tser.load_arrays(p)
    np.testing.assert_array_equal(arrays["x"], a["x"])


def test_logger_formats_like_jax():
    lines = {}
    for name, lg in (("jax", jlog), ("port", tlog)):
        got = []
        lg.set_callback_sink(lambda lvl, msg: got.append((lvl, msg)))
        lg.set_level("info")
        lg.get_logger().info("hello %d", 3)
        lg.set_level(logging.WARNING)
        lg.get_logger().info("dropped")
        lg.set_callback_sink(None)
        lines[name] = got
    assert [m.replace("raft_tpu_torch", "raft_tpu") for _, m in lines["port"]] \
        == [m for _, m in lines["jax"]]
    assert lines["port"] == [(logging.INFO, "[INFO] [raft_tpu_torch] hello 3")]
    with pytest.raises(ValueError):
        tlog.set_level("loud")
