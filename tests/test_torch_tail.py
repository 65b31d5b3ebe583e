"""Port parity for the rest of the surface: ``select_k.merge_topk``, the
resources pool, ``bench.datasets.deep_like_rows``, the host strip planner
(``strip_scan.plan_strips`` / ``StripPlan``) and the search it drives,
``bq_scan.bq_dense_scan`` at its JAX path, the ``ivf_pq`` rotation
aliases, and every package's ``__all__`` against the JAX package's.

Exact where the function is exact (merge, planner, dense scan on
integer-valued inputs). ``deep_like_rows`` cannot replay ``jax.random``,
so it is held by invariants: unit norms, a row the same bits alone or in
any batch, and the 10/50/90% quantiles of the nearest-neighbour cosine
over 5,000 rows, whose mean over eight seeds lies within four standard
errors of the JAX package's mean over eight seeds.
"""

import importlib
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_tpu
import raft_tpu_torch
from raft_tpu.bench.datasets import deep_like_rows as jdeep
from raft_tpu.ops import bq_scan as jbq
from raft_tpu.ops import select_k as jsk
from raft_tpu.ops import strip_scan as jss
from raft_tpu_torch.bench.datasets import deep_like_rows as tdeep
from raft_tpu_torch.core import resources_manager as rm
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import ivf_pq as tivf_pq
from raft_tpu_torch.ops import bq_scan as tbq
from raft_tpu_torch.ops import linalg as tlinalg
from raft_tpu_torch.ops import select_k as tsk
from raft_tpu_torch.ops import strip_scan as tss

torch.set_num_threads(2)
CPU = "cpu"


# -- merge_topk ---------------------------------------------------------------

@pytest.mark.parametrize("select_min", [True, False])
def test_merge_topk_equals_jax(select_min):
    """Small integers, so the two lists tie often: ``a``'s entries win."""
    rng = np.random.default_rng(0)
    va = np.sort(rng.integers(0, 6, (20, 8)).astype(np.float32), axis=1)
    vb = np.sort(rng.integers(0, 6, (20, 8)).astype(np.float32), axis=1)
    if not select_min:
        va, vb = va[:, ::-1].copy(), vb[:, ::-1].copy()
    ia = rng.integers(0, 1000, (20, 8)).astype(np.int32)
    ib = rng.integers(1000, 2000, (20, 8)).astype(np.int32)
    gv, gi = tsk.merge_topk(va, ia, vb, ib, select_min, device=CPU)
    jv, ji = jsk.merge_topk(jnp.asarray(va), jnp.asarray(ia), jnp.asarray(vb),
                            jnp.asarray(ib), select_min)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))
    gv1, gi1 = tsk.merge_topk(va[0], ia[0], vb[0], ib[0], select_min,
                              device=CPU)
    assert torch.equal(gv1, gv[0]) and torch.equal(gi1, gi[0])


# -- the resources pool -------------------------------------------------------

@pytest.fixture
def pool():
    rm.clear_pool()
    saved = dict(rm._DEFAULTS)
    yield rm
    rm.clear_pool()
    rm._DEFAULTS.clear()
    rm._DEFAULTS.update(saved)


def test_pool_serves_one_instance_per_device_to_every_thread(pool):
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        pool.get_resources("cpu"))) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(got) == 16 and all(r is got[0] for r in got)
    assert got[0].device == torch.device("cpu")
    pool.clear_pool()
    assert pool.get_resources("cpu") is not got[0]


def test_pool_defaults_apply_to_entries_made_after_them(pool):
    before = pool.get_resources("cpu")
    pool.set_resource_defaults(workspace_bytes=1 << 20,
                               compute_dtype=torch.bfloat16)
    assert before.workspace_bytes == Resources().workspace_bytes
    pool.clear_pool()
    after = pool.get_resources("cpu")
    assert after.workspace_bytes == 1 << 20
    assert after.compute_dtype == torch.bfloat16


def test_pool_defaults_to_cuda(pool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pool.get_resources()


# -- deep_like_rows -----------------------------------------------------------

def test_deep_like_rows_are_unit_norm_and_addressable():
    ids = np.arange(3000)
    rows = tdeep(ids, device=CPU)
    assert rows.dtype == torch.float32 and tuple(rows.shape) == (3000, 96)
    norms = torch.linalg.vector_norm(rows.double(), dim=1)
    assert float((norms - 1).abs().max()) < 1e-6
    pick = np.array([2999, 0, 1234, 1234, 77])
    assert torch.equal(tdeep(pick, device=CPU), rows[pick])
    assert torch.equal(tdeep(ids.reshape(30, 100), device=CPU),
                       rows.reshape(30, 100, 96))
    small = Resources(device=CPU, workspace_bytes=1 << 16)   # many batches
    assert torch.equal(tdeep(ids, res=small), rows)
    assert not torch.equal(tdeep(pick, seed=1, device=CPU), rows[pick])
    assert tuple(tdeep(pick, dim=33, device=CPU).shape) == (5, 33)


def _nn_cos_quantiles(rows):
    x = torch.as_tensor(np.array(rows), dtype=torch.float64)
    s = x @ x.T
    s.fill_diagonal_(-float("inf"))
    return np.quantile(s.max(1).values.numpy(), [0.1, 0.5, 0.9])


def test_deep_like_rows_quantiles_match_jax():
    """The 10/50/90% quantiles of the nearest-neighbour cosine over 5,000
    rows, seeds 0–7 of each package: the difference of the two means
    within four standard errors, the seed-to-seed standard deviation pooled
    over both (measured here: about 0.001 / 0.007 / 0.008; the differences
    come to 0.8 / 1.3 / 2.2 standard errors).

    The quantiles move with the spreads the few most popular centres draw,
    so one seed against another is no yardstick (JAX's seeds 0 and 1
    differ by 9e-5 at the 10% quantile, a tenth of its standard
    deviation), and six seeds are too few: seeds 0–5 put the port's 90%
    quantile 5.0 standard errors high, where 30 seeds give 0.9081 against
    0.9051 for a numpy draw of the same mixture."""
    ids = np.arange(5000)
    jq = np.array([_nn_cos_quantiles(jdeep(ids, seed=s)) for s in range(8)])
    tq = np.array([_nn_cos_quantiles(tdeep(ids, seed=s, device=CPU))
                   for s in range(8)])
    pooled = np.sqrt((jq.var(0, ddof=1) + tq.var(0, ddof=1)) / 2)
    diff = np.abs(tq.mean(0) - jq.mean(0))
    assert np.all(diff <= 4 * pooled * np.sqrt(2 / 8)), (diff, pooled)


# -- the host strip planner ---------------------------------------------------

def _plan_inputs(kind):
    rng = np.random.default_rng(2)
    n_lists = 64
    lens = rng.integers(0, 6000, n_lists)
    lens[3], lens[5] = 0, 9000
    if kind == "random":
        probes = rng.integers(0, n_lists, (300, 8))
    elif kind == "hot":                 # one list in most pairs: many strips
        probes = np.where(rng.random((900, 4)) < 0.7, 7,
                          rng.integers(0, n_lists, (900, 4)))
    else:
        probes = np.zeros((0, 4))
    return probes.astype(np.int32), lens, n_lists


@pytest.mark.parametrize("kind", ["random", "hot", "none"])
def test_plan_strips_is_bit_for_bit_jax(kind):
    probes, lens, n_lists = _plan_inputs(kind)
    want = jss.plan_strips(probes, lens, n_lists)
    got = tss.plan_strips(probes, lens, n_lists, dim=128)
    for field in ("qids", "strip_list", "pair_strip", "pair_slot"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype == np.int32, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert got.class_layout == want.class_layout
    assert got.n_strips == want.n_strips and got.s_pad == want.s_pad


def test_plan_strips_refuses_a_width_it_would_plan_differently():
    probes, lens, n_lists = _plan_inputs("random")
    tss.plan_strips(probes, lens, n_lists, dim=192)
    with pytest.raises(ValueError, match="MAX_CLASS"):
        tss.plan_strips(probes, lens, n_lists, dim=256)


@pytest.mark.parametrize("list_dtype", [torch.int8, torch.uint8])
def test_host_planned_search_equals_the_device_planned_one(list_dtype,
                                                           monkeypatch):
    """The same pairs in the same strip slots: the host planner's search
    gives the device plan's values and ids bit for bit (K1's plain twin
    here), and runs one class call per class of its plan per tile (two
    tiles of 300 queries, a hot list, a list of two sub-blocks)."""
    rng = np.random.default_rng(3)
    n_lists, m, dim = 16, 8192, 16
    lens = rng.integers(0, 3000, n_lists)
    lens[3], lens[5] = 0, 4500          # an empty list, a two-sub-block one
    probes = np.where(rng.random((600, 2)) < 0.7, 7,
                      rng.integers(0, n_lists, (600, 2))).astype(np.int32)
    lo = -20 if list_dtype == torch.int8 else 0
    data = torch.from_numpy(rng.integers(lo, 20, (n_lists, m, dim))).to(
        list_dtype)
    ids = torch.full((n_lists, m), -1, dtype=torch.int64)
    bias = torch.full((n_lists, m), float("inf"))
    for li in range(n_lists):
        ids[li, :lens[li]] = torch.arange(lens[li]) + li * m
        bias[li, :lens[li]] = torch.from_numpy(
            rng.integers(0, 50, lens[li]).astype(np.float32))
    q = torch.from_numpy(rng.integers(-4, 5, (probes.shape[0], dim)).astype(
        np.float32))
    pr = torch.from_numpy(probes)
    classes, cls_ord = tss.class_info(lens, dim)
    q_tile = tss.fit_q_tile(q.shape[0], pr.shape[1], n_lists, len(classes),
                            10, 1 << 16, dim=dim)
    assert q_tile < q.shape[0]                   # more than one tile
    calls = []
    real = tss.strip_class

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    def scan(plan):
        k1 = tss._k1_class_fn(data, bias, -2.0, 10, False)
        return tss._scan_tiles(q, pr, ids, 10, 10, q_tile, plan, k1)

    monkeypatch.setattr(tss, "strip_class", counting)
    dv, di = scan(lambda start, qt: tss.plan_tile(
        pr, start, qt, torch.from_numpy(cls_ord), classes, n_lists))
    n_device = len(calls)
    hv, hi = scan(tss.host_plan(pr, lens, n_lists, dim))
    assert torch.equal(hv, dv) and torch.equal(hi, di)
    expected = sum(len(tss.plan_strips(probes[s:s + q_tile], lens, n_lists,
                                       dim).class_layout)
                   for s in range(0, q.shape[0], q_tile))
    assert len(calls) - n_device == n_device == expected


# -- the dense packed scan at its JAX path, the ivf_pq aliases ----------------

@pytest.mark.parametrize("k", [4, 300])
def test_bq_dense_scan_at_the_ops_path_equals_jax(k):
    """Integer-valued queries and power-of-two scales: every score is
    exact, so values and ids are equal (k = 300 pads with +inf / -1)."""
    rng = np.random.default_rng(4)
    n_lists, mls, rot_dim, q, p = 6, 40, 32, 9, 3
    codes = rng.integers(0, 256, (n_lists, mls, rot_dim // 8)).astype(
        np.uint8)
    scale = (2.0 ** rng.integers(-2, 3, (n_lists, mls))).astype(np.float32)
    bias = rng.integers(0, 64, (n_lists, mls)).astype(np.float32)
    bias[:, 30:] = np.inf
    ids = np.arange(n_lists * mls, dtype=np.int32).reshape(n_lists, mls)
    ids[:, 30:] = -1
    queries = rng.integers(-3, 4, (q, rot_dim)).astype(np.float32)
    probes = rng.integers(0, n_lists, (q, p)).astype(np.int32)
    pair = rng.integers(0, 8, (q, p)).astype(np.float32)
    jv, ji = jbq.bq_dense_scan(*(jnp.asarray(a) for a in (
        queries, probes, codes, scale, bias, ids)), k, -2.0,
        jnp.asarray(pair))
    tv, ti = tbq.bq_dense_scan(*(torch.from_numpy(a) for a in (
        queries, probes, codes, scale, bias, ids)), k, -2.0,
        torch.from_numpy(pair))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    sharding = importlib.import_module("raft_tpu_torch.distributed._sharding")
    assert not hasattr(sharding, "bq_dense_scan")


def test_ivf_pq_keeps_the_rotation_aliases():
    assert tivf_pq.pad_rot is tlinalg.pad_rot
    assert tivf_pq.make_rotation_matrix is tlinalg.make_rotation_matrix


# -- package re-exports -------------------------------------------------------

#: JAX package names the port's packages do not export, with the reason
NO_COUNTERPART = {}
#: port-only names a package exports beside JAX's, with the reason
PORT_ONLY = {
    "": {"resolve_device": "the device rule: where an entry point runs"},
    "comms": {
        "Mesh": "the shard set the port's comms run over (a jax Mesh in JAX)",
        "make_comms": "builds Comms from Resources.mesh (JAX reads the "
                      "jax mesh)",
        "process_group_mesh": "one shard a torch.distributed rank",
        "shift": "the ring exchange JAX writes as lax.ppermute",
        "shutdown_distributed": "tears down the torch.distributed group",
    },
}
PACKAGES = ["", "analysis", "bench", "cluster", "comms", "core",
            "distributed", "label", "neighbors", "obs", "ops", "random",
            "resilience", "serving", "solver", "sparse", "spectral", "stats",
            "utils"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_all_equals_jax(pkg):
    jmod = importlib.import_module("raft_tpu" + (f".{pkg}" if pkg else ""))
    tmod = importlib.import_module("raft_tpu_torch"
                                   + (f".{pkg}" if pkg else ""))
    want = (set(getattr(jmod, "__all__", ())) - set(NO_COUNTERPART.get(pkg,
                                                                        ()))
            | set(PORT_ONLY.get(pkg, ())))
    assert set(getattr(tmod, "__all__", ())) == want
    for name in tmod.__all__:
        assert getattr(tmod, name) is not None, name


def test_lazy_names_are_what_jax_binds():
    """Modules where JAX binds a module, functions where it binds a
    function (``solver.linear_assignment`` is the function in both)."""
    import types

    for pkg in ("", "ops", "cluster", "neighbors", "solver", "stats",
                "core", "utils"):
        jmod = importlib.import_module("raft_tpu" + (f".{pkg}" if pkg else ""))
        tmod = importlib.import_module("raft_tpu_torch"
                                       + (f".{pkg}" if pkg else ""))
        for name in jmod.__all__:
            if name == "__version__":
                continue
            is_mod = isinstance(getattr(jmod, name), types.ModuleType)
            assert isinstance(getattr(tmod, name), types.ModuleType) \
                == is_mod, (pkg, name)
    assert raft_tpu_torch.ops.select_k_fn is tsk.select_k
    assert raft_tpu_torch.__version__ and raft_tpu.__version__
    with pytest.raises(AttributeError):
        raft_tpu_torch.ops.no_such_name
