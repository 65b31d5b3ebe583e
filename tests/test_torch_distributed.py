"""The port's distributed indexes against the JAX package's on the same
numpy inputs, at world 8 on CPU shards (``local_mesh(8, device="cpu")``
beside ``Comms(local_mesh(8))`` of eight virtual devices):

* ``merge_shards`` bit for bit (the butterfly at world 8, the all-gather
  at world 6), ties included;
* JAX-built sharded indexes saved by the JAX snapshot and loaded by the
  port's (IVF-BQ, which the JAX snapshot has no kind for, carried across
  by its arrays) search as JAX's does: ids equal but at near-ties, values
  at rtol 5e-4, ``coverage`` / ``degraded`` / ``lost_shards`` equal under
  the same lost shard; k-means at ``init="array"`` equal;
* port-built indexes reach JAX's recall within 0.01, and their snapshots
  load in the JAX package and search as the port's do;
* the strip engine (K1's and K2's twins) agrees with the dense engine on
  CPU shards at the scan-score tolerance, so the engine the card runs is
  covered here."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from raft_tpu import resilience as jres
from raft_tpu.bench.datasets import sift_like
from raft_tpu.cluster.kmeans import KMeansParams as JKMeansParams
from raft_tpu.cluster.kmeans_balanced import KMeansBalancedParams as JKBP
from raft_tpu.comms import Comms as JComms
from raft_tpu.comms import local_mesh as jlocal_mesh
from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.core.compat import shard_map
from raft_tpu.distributed import _sharding as jsh
from raft_tpu.distributed import brute_force as jdbf
from raft_tpu.distributed import cagra as jdcg
from raft_tpu.distributed import ivf_bq as jdbq
from raft_tpu.distributed import ivf_flat as jdfl
from raft_tpu.distributed import ivf_pq as jdpq
from raft_tpu.distributed import kmeans as jdkm
from raft_tpu.distributed import snapshot as jsnap
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import ivf_bq as jivf_bq
from raft_tpu.neighbors import ivf_flat as jivf_flat
from raft_tpu.neighbors import ivf_pq as jivf_pq
from raft_tpu_torch import resilience as tres
from raft_tpu_torch.cluster.kmeans import KMeansParams
from raft_tpu_torch.cluster.kmeans_balanced import KMeansBalancedParams
from raft_tpu_torch.comms import comms as C
from raft_tpu_torch.comms import local_mesh
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.distributed import _sharding as tsh
from raft_tpu_torch.distributed import brute_force as tdbf
from raft_tpu_torch.distributed import cagra as tdcg
from raft_tpu_torch.distributed import ivf_bq as tdbq
from raft_tpu_torch.distributed import ivf_flat as tdfl
from raft_tpu_torch.distributed import ivf_pq as tdpq
from raft_tpu_torch.distributed import kmeans as tdkm
from raft_tpu_torch.distributed import snapshot as tsnap
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.neighbors import ivf_bq as tivf_bq
from raft_tpu_torch.neighbors import ivf_flat as tivf_flat
from raft_tpu_torch.neighbors import ivf_pq as tivf_pq
from raft_tpu_torch.neighbors import refine as trefine

torch.set_num_threads(2)
CPU = {"device": "cpu"}
N, DIM, NQ, K = 6000, 16, 200, 10
RTOL = 5e-4


@pytest.fixture(autouse=True)
def _fresh_health():
    jres.reset_shard_health()
    tres.reset_shard_health()
    yield
    jres.reset_shard_health()
    tres.reset_shard_health()


@pytest.fixture(scope="module")
def data():
    x, q = sift_like(N, DIM, NQ, seed=21)
    x, q = x.astype(np.float32), q.astype(np.float32)
    _, gt = tbf.search(tbf.build(x, **CPU), q, K, **CPU)
    return x, q, gt.numpy()


def _jc(world=8):
    return JComms(jlocal_mesh(world))


def _tc(world=8):
    return C.Comms(local_mesh(world, device="cpu"))


def _recall(ids, gt):
    ids, gt = np.asarray(ids), np.asarray(gt)
    return float(np.mean([len(set(a) & set(b)) / gt.shape[1]
                          for a, b in zip(ids, gt)]))


def assert_same_search(got, want, rtol=RTOL, atol=1e-6):
    """ids equal but at near-ties, values at ``rtol``."""
    (tv, ti), (jv, ji) = [(np.asarray(v, np.float64), np.asarray(i))
                          for v, i in (got, want)]
    np.testing.assert_allclose(tv, jv, rtol=rtol, atol=atol)
    tol = rtol * np.maximum(np.abs(jv), 1.0) + atol
    for r in np.nonzero((ti != ji).any(axis=1))[0]:
        diff = set(ti[r].tolist()) ^ set(ji[r].tolist())
        kth = jv[r, -1]
        for c in range(ti.shape[1]):
            if ti[r, c] != ji[r, c]:
                assert abs(tv[r, c] - jv[r, c]) <= tol[r, c], (r, c)
        assert all(i in ti[r] and abs(tv[r][list(ti[r]).index(i)] - kth)
                   <= tol[r, -1] or i in ji[r]
                   and abs(jv[r][list(ji[r]).index(i)] - kth) <= tol[r, -1]
                   for i in diff), (r, diff)


def assert_same_report(got, want):
    assert got.coverage == pytest.approx(want.coverage)
    assert got.degraded == want.degraded
    assert got.lost_shards == want.lost_shards


def _lost(shard):
    jh, th = jres.ShardHealth(), tres.ShardHealth()
    jh.mark_lost(shard, "test")
    th.mark_lost(shard, "test")
    return jh, th


# ---------------------------------------------------------------------------
# merge_shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world,select_min", [(8, True), (8, False),
                                              (6, True)])
def test_merge_shards_is_bitwise_jax(world, select_min):
    rng = np.random.default_rng(world)
    q, k = 16, 7
    vals = rng.integers(0, 6, (world * q, k)).astype(np.float32)  # ties
    ids = rng.permutation(world * q * k).astype(np.int32).reshape(-1, k)
    ids[rng.random(ids.shape) < 0.2] = -1
    vals[ids < 0] = np.inf if select_min else -np.inf

    def body(v, i):
        return jsh.merge_shards(v, i, k, "data", world, select_min)

    jv, ji = shard_map(body, mesh=jlocal_mesh(world),
                       in_specs=(P("data"), P("data")), out_specs=(P(), P()),
                       check_vma=False)(jnp.asarray(vals), jnp.asarray(ids))
    tv, ti = tsh.merge_shards(
        _tc(world), [torch.from_numpy(vals[r * q:(r + 1) * q])
                     for r in range(world)],
        [torch.from_numpy(ids[r * q:(r + 1) * q]) for r in range(world)],
        k, select_min)
    # shard 0's copy is what the JAX package returns (P() out); with ties
    # the butterfly leaves other shards the same set in another order
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji))
    for v, i in zip(tv, ti):
        np.testing.assert_array_equal(np.sort(v.numpy(), 1),
                                      np.sort(np.asarray(jv), 1))


# ---------------------------------------------------------------------------
# brute force
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf_pair(data, tmp_path_factory):
    x, _, _ = data
    jidx = jdbf.build(x, comms=_jc())
    d = tmp_path_factory.mktemp("bf")
    jsnap.save(jidx, d)
    return jidx, tsnap.load(d, _tc()), d


def test_brute_force_snapshot_from_jax_searches_as_jax(bf_pair, data):
    jidx, tidx, _ = bf_pair
    x, q, gt = data
    want = jdbf.search(jidx, q, K)
    got = tdbf.search(tidx, q, K, **CPU)
    assert_same_search(got, want)
    np.testing.assert_array_equal(got[1].numpy(), gt)
    mask = np.random.default_rng(1).random(N) < 0.3
    jf = JBitset.from_mask(mask)
    tf = Bitset.from_numpy_words(np.asarray(jf.bits), N, **CPU)
    assert_same_search(tdbf.search(tidx, q, K, filter=tf, **CPU),
                       jdbf.search(jidx, q, K, filter=jf))
    jh, th = _lost(3)
    want = jdbf.search(jidx, q, K, health=jh)
    got = tdbf.search(tidx, q, K, health=th, **CPU)
    assert_same_search(got, want)
    assert_same_report(got, want)
    assert got.coverage == pytest.approx(7 / 8) and got.lost_shards == (3,)


def test_brute_force_port_build_equals_single_index_and_crosses_back(
        data, tmp_path):
    x, q, gt = data
    tidx = tdbf.build(x[:5001], "inner_product", comms=_tc(), **CPU)
    got = tdbf.search(tidx, q, K, **CPU)
    want = tbf.search(tbf.build(x[:5001], "inner_product", **CPU), q, K,
                      **CPU)
    assert_same_search(got, want)
    tsnap.save(tidx, tmp_path)
    jidx = jsnap.load(tmp_path, _jc())
    assert_same_search(got, jdbf.search(jidx, q, K))


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------


def test_kmeans_fit_from_the_same_centers_equals_jax(data):
    x, _, _ = data
    xs = x[:5003]                                     # padded shards
    w = np.random.default_rng(2).uniform(0.5, 2.0, 5003).astype(np.float32)
    c0 = xs[::500][:10].copy()
    jout, jlab = jdkm.fit(xs, JKMeansParams(n_clusters=10, init="array",
                                            max_iter=15),
                          sample_weight=w, centroids=c0, comms=_jc())
    tout, tlab = tdkm.fit(xs, KMeansParams(n_clusters=10, init="array",
                                           max_iter=15),
                          sample_weight=w, centroids=c0, comms=_tc(), **CPU)
    assert tout.n_iter == int(jout.n_iter)
    np.testing.assert_allclose(tout.centroids.numpy(),
                               np.asarray(jout.centroids), rtol=1e-4,
                               atol=1e-4)
    assert float(tout.inertia) == pytest.approx(float(jout.inertia),
                                                rel=1e-5)
    assert (tlab.numpy() == np.asarray(jlab)).mean() > 0.999


def test_kmeans_fit_balanced_matches_jax_quality_and_degrades_alike(data):
    x, _, _ = data

    def inertia(c):
        return float(((x[:, None, :] - c[None]) ** 2).sum(-1).min(1).sum())

    jc, jlab, jrep = jdkm.fit_balanced(x, 16, JKBP(n_iters=10), comms=_jc())
    tc, tlab, trep = tdkm.fit_balanced(x, 16, KMeansBalancedParams(n_iters=10),
                                       comms=_tc(), **CPU)
    assert tlab.shape == (N,) and trep.coverage == 1.0
    assert inertia(tc.numpy()) <= inertia(np.asarray(jc)) * 1.05
    sizes = np.bincount(tlab.numpy(), minlength=16)
    assert sizes.min() >= 0.25 * N / 16
    jh, th = _lost(5)
    _, _, jrep = jdkm.fit_balanced(x, 16, JKBP(n_iters=4), comms=_jc(),
                                   health=jh)
    tcen, _, trep = tdkm.fit_balanced(x, 16, KMeansBalancedParams(n_iters=4),
                                      comms=_tc(), health=th, **CPU)
    assert (trep.coverage, trep.degraded, trep.dropped) == (
        jrep.coverage, jrep.degraded, jrep.dropped)
    assert bool(torch.isfinite(tcen).all())


# ---------------------------------------------------------------------------
# IVF-Flat / IVF-PQ / IVF-BQ / CAGRA: JAX-built indexes searched by the port
# ---------------------------------------------------------------------------


def _jax_build(kind, x):
    if kind == "ivf_flat":
        return jdfl.build(x, jivf_flat.IvfFlatParams(n_lists=16), comms=_jc())
    if kind == "ivf_pq":
        return jdpq.build(x, jivf_pq.IvfPqParams(n_lists=16, pq_dim=8),
                          comms=_jc())
    if kind == "ivf_bq":
        return jdbq.build(x, jivf_bq.IvfBqParams(n_lists=16), comms=_jc())
    raise ValueError(kind)


def _carry_bq(jidx, comms):
    """A JAX-built sharded IVF-BQ index as the port's, by its arrays (the
    JAX snapshot has no IVF-BQ kind)."""
    def parts(a):
        a = np.asarray(a)
        return [torch.from_numpy(a[r].copy()) for r in range(a.shape[0])]

    return tdbq.ShardedIvfBqIndex(
        torch.from_numpy(np.asarray(jidx.centers)),
        torch.from_numpy(np.asarray(jidx.rotation)), parts(jidx.list_codes),
        parts(jidx.list_ids), parts(jidx.list_scale), parts(jidx.bias),
        jidx.metric, jidx.n_total, comms, np.asarray(jidx.lens_max),
        jidx.bits, jidx.rotation_kind)


@pytest.fixture(scope="module")
def ivf_pairs(data, tmp_path_factory):
    x, _, _ = data
    out = {}
    for kind in ("ivf_flat", "ivf_pq", "ivf_bq"):
        jidx = _jax_build(kind, x)
        if kind == "ivf_bq":
            out[kind] = (jidx, _carry_bq(jidx, _tc()), None)
            continue
        d = tmp_path_factory.mktemp(kind)
        jsnap.save(jidx, d)
        out[kind] = (jidx, tsnap.load(d, _tc()), d)
    return out


_SEARCH = {"ivf_flat": (jdfl.search, tdfl.search),
           "ivf_pq": (jdpq.search, tdpq.search),
           "ivf_bq": (jdbq.search, tdbq.search)}


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq", "ivf_bq"])
def test_jax_built_ivf_searches_as_jax(ivf_pairs, data, kind):
    _, q, _ = data
    jidx, tidx, _ = ivf_pairs[kind]
    jsearch, tsearch = _SEARCH[kind]
    assert tidx.max_list_size == jidx.max_list_size
    got = tsearch(tidx, q, 20, n_probes=5, **CPU)
    want = jsearch(jidx, q, 20, n_probes=5)
    assert_same_search(got, want, atol=1e-4)
    assert_same_report(got, want)
    jh, th = _lost(2)
    got = tsearch(tidx, q, 20, n_probes=5, health=th, **CPU)
    want = jsearch(jidx, q, 20, n_probes=5, health=jh)
    assert_same_search(got, want, atol=1e-4)
    assert_same_report(got, want)
    assert got.degraded and got.lost_shards == (2,)
    assert not np.isin(got[1].numpy(), np.arange(2 * 750, 3 * 750)).any()


_PORT_PARAMS = {
    "ivf_flat": (tdfl, tivf_flat.IvfFlatParams(n_lists=16),
                 jdfl, jivf_flat.IvfFlatParams(n_lists=16)),
    "ivf_pq": (tdpq, tivf_pq.IvfPqParams(n_lists=16, pq_dim=8),
               jdpq, jivf_pq.IvfPqParams(n_lists=16, pq_dim=8)),
    "ivf_bq": (tdbq, tivf_bq.IvfBqParams(n_lists=16),
               jdbq, jivf_bq.IvfBqParams(n_lists=16)),
}


@pytest.fixture(scope="module")
def port_built(data):
    x, _, _ = data
    return {kind: mod.build(x, params, comms=_tc(), **CPU)
            for kind, (mod, params, _, _) in _PORT_PARAMS.items()}


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq", "ivf_bq"])
def test_port_built_ivf_recall_is_the_jax_builds(ivf_pairs, port_built,
                                                 data, kind):
    x, q, gt = data
    jidx, _, _ = ivf_pairs[kind]
    jsearch, tsearch = _SEARCH[kind]
    tidx = port_built[kind]
    _, jcand = jsearch(jidx, q, 40, n_probes=6)
    _, tcand = tsearch(tidx, q, 40, n_probes=6, **CPU)
    _, jids = trefine.refine(x, q, np.asarray(jcand), K, **CPU)
    _, tids = trefine.refine(x, q, tcand, K, **CPU)
    j_rec, t_rec = _recall(jids, gt), _recall(tids, gt)
    assert t_rec >= j_rec - 0.01, (kind, t_rec, j_rec)
    assert t_rec > 0.8


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_port_snapshot_loads_in_jax_and_searches_alike(port_built, data,
                                                       kind, tmp_path):
    _, q, _ = data
    tidx = port_built[kind]
    tsnap.save(tidx, tmp_path)
    jidx = jsnap.load(tmp_path, _jc())
    jsearch, tsearch = _SEARCH[kind]
    assert_same_search(tsearch(tidx, q, 20, n_probes=5, **CPU),
                       jsearch(jidx, q, 20, n_probes=5), atol=1e-4)
    back = tsnap.load(tmp_path, _tc())
    for a, b in zip(back.list_ids, tidx.list_ids):
        assert torch.equal(a, b)


def test_snapshot_restore_and_recover_after_a_lost_shard(ivf_pairs, data):
    _, q, _ = data
    _, tidx, d = ivf_pairs["ivf_pq"]
    before = tdpq.search(tidx, q, 20, n_probes=5, **CPU)
    broken = tsnap.restore_shard(tidx, d, 4)          # a no-op reload
    for a, b in zip(broken.decoded, tidx.decoded):
        assert torch.equal(a, b)
    wiped = tidx.__class__(**{**tidx.__dict__,
                              "decoded": [t.clone() for t in tidx.decoded]})
    wiped.decoded[4].zero_()
    health = tres.ShardHealth()
    health.mark_lost(4, "test")
    degraded = tdpq.search(wiped, q, 20, n_probes=5, health=health, **CPU)
    assert degraded.coverage == pytest.approx(7 / 8)
    fixed, recovered = tsnap.recover(wiped, d, health)
    assert recovered == (4,) and health.lost() == ()
    after = tdpq.search(fixed, q, 20, n_probes=5, health=health, **CPU)
    assert after.coverage == 1.0 and not after.degraded
    np.testing.assert_array_equal(after[1].numpy(), before[1].numpy())
    np.testing.assert_array_equal(after[0].numpy(), before[0].numpy())
    with pytest.raises(ValueError, match="resharding"):
        tsnap.load(d, _tc(4))
    with pytest.raises(ValueError, match="out of range"):
        tsnap.restore_shard(tidx, d, 8)
    with pytest.raises(FileNotFoundError, match="manifest"):
        tsnap.read_manifest(d / "nope")


# ---------------------------------------------------------------------------
# the engines: strip (K1 / K2 twins on CPU shards) against dense
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def granule_built(data):
    """Port-built indexes at the 512-row granule, so the strip engine can
    take their lists."""
    x, _, _ = data
    return {
        "ivf_flat": tdfl.build(x, tivf_flat.IvfFlatParams(n_lists=8,
                                                          group_size=512),
                               comms=_tc(), **CPU),
        "ivf_pq": tdpq.build(x, tivf_pq.IvfPqParams(n_lists=8, pq_dim=8,
                                                    group_size=512),
                             comms=_tc(), **CPU),
        "ivf_bq": tdbq.build(x, tivf_bq.IvfBqParams(n_lists=8), comms=_tc(),
                             **CPU)}


def _engine_args(kind, idx, q):
    qt = torch.from_numpy(q)
    if kind == "ivf_flat":
        probes = tivf_flat._coarse_probes(qt, idx.centers, 4, "sqeuclidean")
        return qt, probes, None, idx.list_data, None, "strip"
    if kind == "ivf_pq":
        probes, qr, pc = tivf_pq._pq_probe_prep(qt, idx.centers, idx.rotation,
                                                4, "exact", True)
        return qr * idx.decoded_scale, probes, pc, idx.decoded, None, "strip"
    probes, qr, pc = tivf_bq._bq_search_prep(qt, idx.centers, idx.rotation, 4,
                                             "exact", True, idx.bits,
                                             idx.rotation_kind)
    return qr, probes, pc, idx.list_codes, idx.list_scale, "bq"


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq", "ivf_bq"])
def test_strip_engine_agrees_with_dense_on_cpu_shards(granule_built, data,
                                                      kind):
    _, q, _ = data
    idx = granule_built[kind]
    assert idx.max_list_size % 512 == 0
    qm, probes, pc, lists, scale, scan = _engine_args(kind, idx, q[:64])
    outs = {}
    for dense in (True, False):
        outs[dense] = tsh.tiled_search(
            qm, probes, idx.lens_max, idx.n_lists, K, idx.comms, -2.0, dense,
            lists, idx.list_ids, idx.bias, pair_const=pc, n_total=N,
            scale=scale, scan=scan)
    # the strip engine rounds the query operand to bf16 (2^-9 relative),
    # the dense engine keeps fp32: the flat scan's scan-score tolerance,
    # and for the int8 cache and the ±1 codes (exact in bf16) the
    # rounding's Cauchy-Schwarz bound |alpha|·2^-8·max‖a‖·max‖b‖·max scale
    if kind == "ivf_flat":
        atol = 5e-4 * float((qm.float() ** 2).sum(1).max())
    else:
        b_norm = (max(float(t.float().norm(dim=2).max()) for t in lists)
                  if kind == "ivf_pq" else (8.0 * lists[0].shape[2]) ** 0.5)
        s_max = (1.0 if scale is None
                 else max(float(t.max()) for t in scale))
        atol = 2.0 * 2 ** -8 * float(qm.float().norm(dim=1).max()) \
            * b_norm * s_max
    (sv, si, _), (dv, di, _) = outs[False], outs[True]
    assert (si >= 0).all()
    # ids equal but where two candidates score within the tolerance
    assert_same_search((sv, si), (dv, di), rtol=0.0, atol=2 * atol)


# ---------------------------------------------------------------------------
# CAGRA (world 2: each shard past the 4,096 rows that seed by centroids,
# so both packages' compressed loops are deterministic)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cagra_pair(tmp_path_factory):
    x, q = sift_like(8400, DIM, 100, seed=22)
    x, q = x.astype(np.float32), q.astype(np.float32)
    params = dict(intermediate_graph_degree=24, graph_degree=16,
                  compress="on")
    jidx = jdcg.build(x, jcagra.CagraParams(**params), comms=_jc(2))
    d = tmp_path_factory.mktemp("cagra")
    jsnap.save(jidx, d)
    tidx = tsnap.load(d, _tc(2))
    tbuilt = tdcg.build(x, tcagra.CagraParams(**params), comms=_tc(2), **CPU)
    _, gt = tbf.search(tbf.build(x, **CPU), q, K, **CPU)
    return x, q, gt.numpy(), jidx, tidx, tbuilt


def test_jax_built_cagra_searches_as_jax(cagra_pair, monkeypatch):
    _, q, _, jidx, tidx, _ = cagra_pair
    assert tidx.centroids is not None
    hops = []
    monkeypatch.setattr(tcagra, "fused_hop",
                        lambda *a, **k: hops.append(1))  # must stay unused
    sp = dict(itopk_size=32, search_width=2)
    stats = {}
    got = tdcg.search(tidx, q, K, tcagra.CagraSearchParams(
        traversal="fused", **sp), stats=stats, **CPU)
    want = jdcg.search(jidx, q, K, jcagra.CagraSearchParams(**sp))
    assert stats["mode"] == "compressed" and not hops
    assert_same_search(got, want, atol=1e-3)
    jh, th = _lost(1)
    got = tdcg.search(tidx, q, K, tcagra.CagraSearchParams(**sp), health=th,
                      **CPU)
    want = jdcg.search(jidx, q, K, jcagra.CagraSearchParams(**sp), health=jh)
    assert_same_report(got, want)
    assert_same_search(got, want, atol=1e-3)


def test_port_built_cagra_recall_is_the_jax_builds(cagra_pair, tmp_path):
    _, q, gt, jidx, _, tbuilt = cagra_pair
    sp = dict(itopk_size=32, search_width=2)
    _, jids = jdcg.search(jidx, q, K, jcagra.CagraSearchParams(**sp))
    got = tdcg.search(tbuilt, q, K, tcagra.CagraSearchParams(**sp), **CPU)
    j_rec, t_rec = _recall(jids, gt), _recall(got[1], gt)
    assert t_rec >= j_rec - 0.01 and t_rec > 0.9, (t_rec, j_rec)
    tsnap.save(tbuilt, tmp_path)
    back = jdcg.search(jsnap.load(tmp_path, _jc(2)), q, K,
                       jcagra.CagraSearchParams(**sp))
    assert_same_search(got, back, atol=1e-3)


def test_shard_bodies_never_resolve_to_the_fused_hop():
    for traversal in ("auto", "fused", "compressed"):
        mode, rt = tcagra._resolve_traversal(
            tcagra.CagraSearchParams(traversal=traversal), True, 10, 64,
            size=100_000, width=4, degree=64, proj_dim=64, on_cuda=True,
            allow_fused=False)
        assert (mode, rt) == ("compressed", 64)
    mode, _ = tcagra._resolve_traversal(
        tcagra.CagraSearchParams(), True, 10, 64, size=100_000, width=4,
        degree=64, proj_dim=64, on_cuda=True)
    assert mode == "fused"         # the single index keeps K6


# ---------------------------------------------------------------------------
# armed shard faultpoints: JAX's degraded-search tests, on both packages
# ---------------------------------------------------------------------------


@pytest.fixture
def arm_both(monkeypatch):
    """Arm a spec through ``RAFT_TPU_FAULTS`` in both packages (each keeps
    its own fault table); disarmed after the test."""
    from raft_tpu.resilience import faultinject as jfi
    from raft_tpu_torch.resilience import faultinject as tfi

    def arm(spec):
        monkeypatch.setenv("RAFT_TPU_FAULTS", spec)
        jfi.reset()
        tfi.reset()

    yield arm
    monkeypatch.delenv("RAFT_TPU_FAULTS", raising=False)
    jfi.reset()
    tfi.reset()


@pytest.mark.parametrize("spec", [
    "distributed.brute_force.search.shard=fatal:1",
    "distributed.brute_force.search.shard=transient:1",
    "distributed.ivf_flat.search.shard=fatal:1"])
def test_armed_shard_faultpoint_degrades_and_recovers_as_jax(
        bf_pair, ivf_pairs, data, arm_both, spec):
    """The first shard probed fails: the search answers over the
    survivors (equal to JAX's under the same fault), a FATAL loss stays
    lost on the next search, a TRANSIENT one heals to full coverage."""
    _, q, _ = data
    if ".brute_force." in spec:
        jidx, tidx, _ = bf_pair
        jargs, targs = (jidx, q, K), (tidx, q, K)
        jfn, tfn, kw = jdbf.search, tdbf.search, {}
    else:
        jidx, tidx, _ = ivf_pairs["ivf_flat"]
        jargs, targs = (jidx, q, K), (tidx, q, K)
        jfn, tfn, kw = jdfl.search, tdfl.search, {"n_probes": 5}

    def jsearch():
        return jfn(*jargs, **kw)

    def tsearch():
        return tfn(*targs, **kw, **CPU)

    arm_both(spec)
    want, got = jsearch(), tsearch()
    assert got.degraded and got.lost_shards == (0,)
    assert got.coverage == pytest.approx(7 / 8)
    assert_same_report(got, want)
    assert_same_search(got, want, atol=1e-4)
    events = [e["event"] for e in tres.recent_events()]
    assert "partial_merge" in events
    fatal = spec.endswith("=fatal:1")
    assert tres.shard_health().state(0) == (tres.LOST if fatal
                                            else tres.SUSPECT)
    want2, got2 = jsearch(), tsearch()
    assert_same_report(got2, want2)
    assert got2.degraded == fatal and got2.coverage == pytest.approx(
        7 / 8 if fatal else 1.0)
    assert tres.shard_health().state(0) == (tres.LOST if fatal
                                            else tres.HEALTHY)


def test_armed_kmeans_shard_faultpoint_degrades_as_jax(data, arm_both):
    x, _, _ = data
    arm_both("distributed.kmeans.fit.shard=fatal:1")
    _, _, jrep = jdkm.fit_balanced(x, 16, JKBP(n_iters=4), comms=_jc())
    tcen, tlab, trep = tdkm.fit_balanced(
        x, 16, KMeansBalancedParams(n_iters=4), comms=_tc(), **CPU)
    assert (trep.coverage, trep.degraded, trep.dropped) == (
        jrep.coverage, jrep.degraded, jrep.dropped)
    assert trep.degraded and 0 in trep.dropped
    assert bool(torch.isfinite(tcen).all()) and tlab.shape == (N,)
