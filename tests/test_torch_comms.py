"""The port's comms layer against the JAX package's: every collective on
``local_mesh(8, device="cpu")`` (and 6 shards, and a 2 × 4 split) equals
the JAX collective on ``Comms(local_mesh(8))`` for the same input; the
nine self-tests pass on both transports (a gloo process group of two
spawned processes); the bootstrap's sources, probe and device rule."""

import multiprocessing as mp
import socket

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import torch_dist_worker
from raft_tpu.comms import Comms as JComms
from raft_tpu.comms import comms as JC
from raft_tpu.comms import local_mesh as jlocal_mesh
from raft_tpu.core.compat import shard_map
from raft_tpu_torch import resilience
from raft_tpu_torch.comms import bootstrap
from raft_tpu_torch.comms import comms as C
from raft_tpu_torch.comms import comms_self_test, local_mesh
from raft_tpu_torch.comms.self_test import _ALL_TESTS
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.distributed import brute_force as dbf

torch.set_num_threads(2)
M, D = 3, 5          # rows and width of each shard's block


def _jax_run(world, fn, x, in_spec=P("data"), out_spec=P("data")):
    mesh = jlocal_mesh(world)
    return np.asarray(shard_map(fn, mesh=mesh, in_specs=(in_spec,),
                                out_specs=out_spec, check_vma=False)(
        jnp.asarray(x)))


def _blocks(x, world):
    per = x.shape[0] // world
    return [torch.from_numpy(x[r * per:(r + 1) * per].copy())
            for r in range(world)]


def _stack(outs):
    return np.concatenate([o.numpy() for o in outs], axis=0)


def _data(world, rows=M, seed=0):
    rng = np.random.default_rng(seed + world)
    return rng.standard_normal((world * rows, D)).astype(np.float32)


def _comms(world):
    return C.Comms(local_mesh(world, device="cpu"))


@pytest.mark.parametrize("world", [8, 6])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_allreduce_and_reduce_equal_jax(world, op):
    x = _data(world)
    want = _jax_run(world, lambda s: JC.allreduce(s, op, "data"), x)
    for fn in (lambda c, xs: C.allreduce(c, xs, op),
               lambda c, xs: C.reduce(c, xs, 2, op)):
        got = _stack(fn(_comms(world), _blocks(x, world)))
        if op == "sum":  # rank-order sums against XLA's all-reduce
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", [8, 6])
def test_bcast_equals_jax(world):
    x = _data(world)
    want = _jax_run(world, lambda s: JC.bcast(s, 3, "data"), x)
    got = _stack(C.bcast(_comms(world), _blocks(x, world), 3))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", [8, 6])
@pytest.mark.parametrize("tiled,axis", [(True, 0), (False, 0), (True, 1),
                                        (False, 1)])
def test_allgather_and_gather_equal_jax(world, tiled, axis):
    x = _data(world)
    want = _jax_run(world, lambda s: JC.allgather(s, "data", tiled=tiled,
                                                  gather_axis=axis),
                    x, out_spec=P())
    outs = C.allgather(_comms(world), _blocks(x, world), tiled=tiled,
                       gather_axis=axis)
    for o in outs:
        np.testing.assert_array_equal(o.numpy(), want)
    if axis == 0:
        want_g = _jax_run(world, lambda s: JC.gather(s, 0, "data",
                                                     tiled=tiled),
                          x, out_spec=P())
        got_g = C.gather(_comms(world), _blocks(x, world), 0, tiled=tiled)
        np.testing.assert_array_equal(got_g[0].numpy(), want_g)


@pytest.mark.parametrize("world", [8, 6])
def test_reducescatter_equals_jax(world):
    x = _data(world, rows=world * 2)
    want = _jax_run(world, lambda s: JC.reducescatter(s, "sum", "data"), x)
    got = _stack(C.reducescatter(_comms(world), _blocks(x, world)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("perm", [[(0, 3), (3, 0), (1, 2)],
                                  [(i, (i + 1) % 8) for i in range(8)],
                                  [(i, (i + 3) % 8) for i in range(8)],
                                  [(i, i ^ 4) for i in range(8)]])
def test_sendrecv_equals_jax_ppermute(perm):
    x = _data(8)
    want = _jax_run(8, lambda s: JC.sendrecv(s, perm, "data"), x)
    got = _stack(C.sendrecv(_comms(8), _blocks(x, 8), perm))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("offset", [1, 3])
def test_shift_equals_jax(offset):
    x = _data(8)
    want = _jax_run(8, lambda s: JC.shift(s, offset, "data"), x)
    got = _stack(C.shift(_comms(8), _blocks(x, 8), offset))
    np.testing.assert_array_equal(got, want)


def test_barrier_and_ranks_equal_jax():
    x = np.zeros((8, 1), np.int32)
    want = _jax_run(8, lambda s: s + JC.barrier("data"), x)
    comm = _comms(8)
    assert (want == C.barrier(comm)).all() and C.get_size(comm) == 8
    ranks = _jax_run(8, lambda s: s + JC.get_rank("data"), x)
    assert C.get_rank(comm) == ranks[:, 0].tolist()


def test_split_2x4_equals_jax():
    x = np.random.default_rng(3).standard_normal((2, 4)).astype(np.float32)
    jrow, jcol = JComms(jlocal_mesh(8)).split(2, 4)

    def body(s):
        return (JC.allreduce(s, "sum", jrow.axis),
                JC.allreduce(s, "sum", jcol.axis),
                JC.allgather(s, jcol.axis, tiled=True, gather_axis=1))

    r, c, g = shard_map(body, mesh=jrow.mesh, in_specs=(P("row", "col"),),
                        out_specs=(P("row", "col"),) * 3,
                        check_vma=False)(jnp.asarray(x))
    r, c, g = np.asarray(r), np.asarray(c), np.asarray(g)
    row, col = _comms(8).split(2, 4)
    assert (row.size, col.size) == (2, 4)
    xs = [torch.tensor([[x[g_ // 4, g_ % 4]]]) for g_ in range(8)]
    tr = C.allreduce(row, xs)
    tc_ = C.allreduce(col, xs)
    tg = C.allgather(col, xs, tiled=True, gather_axis=1)
    for g_ in range(8):
        i, j = divmod(g_, 4)
        np.testing.assert_allclose(tr[g_].numpy()[0, 0], r[i, j], rtol=1e-6)
        np.testing.assert_allclose(tc_[g_].numpy()[0, 0], c[i, j], rtol=1e-6)
        np.testing.assert_array_equal(tg[g_].numpy()[0], g[i, 4 * j:4 * j + 4])
    assert row.ranks == [g_ // 4 for g_ in range(8)]
    assert col.ranks == [g_ % 4 for g_ in range(8)]


@pytest.mark.parametrize("world", [1, 6, 8])
def test_self_test_passes_on_the_local_transport(world):
    assert comms_self_test(local_mesh(world, device="cpu")) == {
        name: True for name in _ALL_TESTS}


def test_collectives_refuse_a_wrong_shard_count():
    with pytest.raises(ValueError, match="one tensor per local shard"):
        C.allreduce(_comms(4), [torch.zeros(1)] * 3)
    with pytest.raises(ValueError, match="allreduce op"):
        C.allreduce(_comms(2), [torch.zeros(1)] * 2, "prod")
    with pytest.raises(ValueError, match="rows\\*cols"):
        _comms(8).split(3, 2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_process_group_transport_on_gloo_equals_local():
    """Two spawned ranks: the nine self-tests pass over gloo, and a
    distributed brute-force search equals the local transport's at
    world 2."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    addr = f"127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=torch_dist_worker.gloo_rank,
                         args=(r, 2, addr, queue)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = [queue.get(timeout=150) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    assert all(not p.is_alive() for p in procs)
    errors = [g for g in got if g[1] == "error"]
    assert not errors, errors[0][2]
    x, q = torch_dist_worker.dataset()
    idx = dbf.build(x, comms=_comms(2), device="cpu")
    want_v, want_i = dbf.search(idx, q, 5, device="cpu")
    for rank, checks, vals, ids in got:
        assert checks == {name: True for name in _ALL_TESTS}, (rank, checks)
        np.testing.assert_array_equal(ids, want_i.numpy())
        np.testing.assert_array_equal(vals, want_v.numpy())


def test_init_distributed_without_a_source_does_nothing(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert bootstrap.init_distributed() is False
    assert not bootstrap.distributed_ready()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        bootstrap.init_distributed()


def test_unreachable_coordinator_is_transient():
    with pytest.raises(RuntimeError, match="UNAVAILABLE") as e:
        bootstrap._probe_coordinator(f"127.0.0.1:{_free_port()}", 0.5)
    assert resilience.classify(e.value) == resilience.TRANSIENT


def test_meshes_follow_the_device_rule(monkeypatch):
    mesh = local_mesh(4, device="cpu")
    assert mesh.size == 4 and mesh.transport == "local"
    assert local_mesh(device="cpu").size == 1
    two_d = local_mesh(8, ("a", "b"), (2, 4), device="cpu")
    assert two_d.shape == {"a": 2, "b": 4}
    with pytest.raises(ValueError, match="mesh shape"):
        local_mesh(8, ("a",), (2, 4), device="cpu")
    mixed = np.array([[torch.device("cpu"), torch.device("cuda", 0)]] * 2,
                     dtype=object)
    with pytest.raises(ValueError, match=r"one device type, found "
                                         r"\['cpu', 'cuda'\]"):
        C.Mesh(mixed, ("a", "b"))
    assert C.make_comms(Resources(device="cpu")).size == 1
    installed = Resources(device="cpu", mesh=mesh)
    assert C.make_comms(installed).size == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        local_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        C.make_comms()
