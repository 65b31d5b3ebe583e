"""Port parity of the IVF-PQ remainder: the LUT backends ("pallas" through
K5's twin, "gather"), backend resolution, streamed builds (codes and
cache-only), extend, reconstruct_rows, per-cluster codebooks and the
streamed-build helpers, held against raft_tpu on the same numpy data.

The JAX side runs as its own tests run it: ``search(backend="pallas")``
interprets the Pallas kernel on the CPU. Search parity is held on indexes
built by the JAX package and carried across; the port's own builds (its
random streams are not ``jax.random``'s) by invariants and recall.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import _packing as jpk
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import refine as jref
from raft_tpu.ops import linalg as jla
from raft_tpu.stats import metrics as jmet
from raft_tpu_torch.bench.datasets import sift_like
from raft_tpu_torch.neighbors import _packing as tpk
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import refine as trf
from raft_tpu_torch.ops import linalg as tla
from raft_tpu_torch.stats import metrics as tmet

torch.set_num_threads(2)

CPU = "cpu"
METRICS = ["sqeuclidean", "euclidean", "inner_product", "cosine"]


@pytest.fixture(scope="module")
def data():
    ds, qs = sift_like(20_000, 32, 200, seed=3)
    return ds.astype(np.float32), qs.astype(np.float32)


@pytest.fixture(scope="module")
def gt(data):
    ds, qs = data
    v, i = jbf.search(jbf.build(ds), qs, 10)
    return np.array(v), np.array(i)


@pytest.fixture(scope="module")
def jax_indexes(data):
    """JAX-built 128-granule indexes at pq_bits 4 and 8."""
    return {bits: jpq.build(data[0], jpq.IvfPqParams(
        n_lists=64, pq_dim=16, pq_bits=bits, group_size=128,
        kmeans_n_iters=10, codebook_n_iters=10))
        for bits in (4, 8)}


def _as_metric(jidx, metric):
    """The same JAX index under another metric: inner-product metrics keep
    no list-side LUT half, so their b_sum is 0 (+inf at padding)."""
    if metric in ("sqeuclidean", "euclidean"):
        return dataclasses.replace(jidx, metric=metric, decoded=None)
    b_sum = jnp.where(jidx.list_ids >= 0, 0.0, jnp.inf).astype(jnp.float32)
    return dataclasses.replace(jidx, metric=metric, b_sum=b_sum, decoded=None)


def _carried(jidx):
    meta = {"kind": "ivf_pq", "metric": jidx.metric, "pq_bits": jidx.pq_bits,
            "group_size": jidx.group_size, "codebook_kind": jidx.codebook_kind,
            "pq_dim_hint": jidx.pq_dim_hint}
    names = ["centers", "rotation", "codebooks", "list_codes", "list_ids",
             "b_sum"]
    if jidx.list_codes.shape[-1] == 0:
        names += ["decoded", "decoded_scale"]
    arrays = {k: np.asarray(getattr(jidx, k)) for k in names}
    return tpq.from_jax_arrays(meta, arrays, device=CPU)


def _t(x):
    return torch.from_numpy(np.array(x))


def _agree(jv, ji, tv, ti, rtol, atol=0.0, tie_rtol=1e-3):
    return tmet.topk_agreement(_t(jv), _t(ji), tv, ti, rtol=rtol, atol=atol,
                               tie_rtol=tie_rtol, max_mismatch=0.01)


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_query_luts_match_jax(data, jax_indexes, metric):
    """fp32 tables within rtol 1e-5; the share of bf16 entries that round
    to another value (the diagnosis when LUT-search values differ) stays
    ≤ 1e-3."""
    j = jax_indexes[8]
    qs = data[1]
    want = np.asarray(jpq._query_luts(jnp.asarray(qs), j.rotation,
                                      j.codebooks, metric, jnp.float32))
    port = _carried(j)
    got = tpq._query_luts(torch.from_numpy(qs), port.rotation, port.codebooks,
                          metric, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    want_bf = np.asarray(jpq._query_luts(jnp.asarray(qs), j.rotation,
                                         j.codebooks, metric, jnp.bfloat16),
                         np.float32)
    got_bf = tpq._query_luts(torch.from_numpy(qs), port.rotation,
                             port.codebooks, metric,
                             torch.bfloat16).float().numpy()
    share = float((got_bf != want_bf).mean())
    assert share <= 1e-3, share


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("bits", [4, 8])
def test_pallas_search_on_jax_index_matches(data, jax_indexes, bits, metric):
    _, qs = data
    j = _as_metric(jax_indexes[bits], metric)
    jv, ji = jpq.search(j, qs, 20, n_probes=8, backend="pallas")
    st = {}
    tv, ti = tpq.search(_carried(j), qs, 20, n_probes=8, backend="pallas",
                        device=CPU, stats=st)
    assert st["backend"] == "pallas" and st["tiles"] >= 1
    # values: bf16 LUT entries that round apart (≤ 1e-3 of them) move a
    # score by one bf16 quantum of one term; ids: near-ties only
    verdict = _agree(jv, ji, tv, ti, rtol=5e-4,
                     atol=5e-4 * float(np.abs(np.asarray(jv)).max()))
    assert verdict["ok"], verdict


def test_pallas_refined_recall_within_0_005(data, gt, jax_indexes):
    ds, qs = data
    kf, n_probes = 40, 8
    j = jax_indexes[8]
    _, cand = jpq.search(j, qs, kf, n_probes=n_probes, backend="pallas")
    v, i = jref.refine(ds, qs, cand, 10)
    want = float(jmet.neighborhood_recall(i, gt[1], v, gt[0]))
    _, cand = tpq.search(_carried(j), qs, kf, n_probes=n_probes,
                         backend="pallas", device=CPU)
    v, i = trf.refine(ds, qs, cand, 10, device=CPU)
    got = tmet.neighborhood_recall(i, _t(gt[1]), v, _t(gt[0]))
    assert abs(got - want) <= 0.005, (got, want)


N_CLUSTER = 4_000
CLUSTER = dict(n_lists=16, pq_dim=16, pq_bits=5, codebook_kind="cluster",
               group_size=128, kmeans_n_iters=10, codebook_n_iters=10)


@pytest.fixture(scope="module")
def jax_cluster(data):
    return jpq.build(data[0][:N_CLUSTER], jpq.IvfPqParams(**CLUSTER))


@pytest.mark.parametrize("kind", ["subspace", "cluster"])
def test_gather_search_on_jax_index_matches(data, jax_indexes, jax_cluster,
                                            kind):
    _, qs = data
    j = jax_indexes[4] if kind == "subspace" else jax_cluster
    jv, ji = jpq.search(j, qs, 10, n_probes=6, backend="gather")
    tv, ti = tpq.search(_carried(j), qs, 10, n_probes=6, backend="gather",
                        device=CPU)
    verdict = _agree(jv, ji, tv, ti, rtol=1e-5,
                     atol=1e-5 * float(np.abs(np.asarray(jv)).max()),
                     tie_rtol=1e-5)
    assert verdict["ok"], verdict


def _skewed_data():
    rng = np.random.default_rng(11)
    hot = rng.normal(scale=0.05, size=(3000, 16)).astype(np.float32)
    cold = rng.normal(loc=30.0, scale=4.0, size=(1000, 16)).astype(np.float32)
    qs = rng.normal(scale=0.05, size=(128, 16)).astype(np.float32)
    return np.concatenate([hot, cold]), qs


def _initial_cap(q, n_probes, n_lists):
    """The JAX package's starting per-list cap: twice the mean load,
    16-aligned (its pallas search escalates from there)."""
    return -(-max(16, 2 * q * n_probes // n_lists) // 16) * 16


def test_probe_skew_escalates_and_matches_gather():
    """The JAX package's adversarial case: every query probes the same hot
    lists, the per-list load is far above twice the mean. The reference
    escalates its cap there; K5's pair-driven scan takes every pair in one
    attempt with none dropped, and matches the gather backend."""
    ds, qs = _skewed_data()
    idx = tpq.build(ds, tpq.IvfPqParams(n_lists=64, pq_dim=8, pq_bits=6,
                                        seed=0), device=CPU)
    assert idx.max_list_size % 128 == 0
    st = {}
    vp, ip_ = tpq.search(idx, qs, 10, n_probes=8, backend="pallas",
                         device=CPU, stats=st)
    vg, ig = tpq.search(idx, qs, 10, n_probes=8, backend="gather", device=CPU)
    assert st["attempts"] == [{"qpl_cap": st["qpl_cap"], "dropped": 0}]
    assert st["tiles"] == len(st["max_list_load"]) == 1
    assert st["qpl_cap"] > _initial_cap(128, 8, 64)    # the skew is there
    np.testing.assert_allclose(np.sort(vp.numpy(), 1), np.sort(vg.numpy(), 1),
                               rtol=1e-3, atol=1e-3)
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in
                       zip(ip_.tolist(), ig.tolist())])
    assert overlap >= 0.95, overlap


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_pallas_on_skewed_jax_index_matches_its_escalation(metric):
    """A JAX-built skewed index carried across: the reference's pallas
    search escalates its cap (the hot lists' load is past its starting
    cap), the port's runs one attempt over the same pairs, and the two
    agree as the unskewed pallas searches do. Tiles of 48 queries in the
    port change nothing."""
    ds, qs = _skewed_data()
    j = _as_metric(jpq.build(ds, jpq.IvfPqParams(
        n_lists=64, pq_dim=8, pq_bits=6, group_size=128, kmeans_n_iters=10,
        codebook_n_iters=10)), metric)
    jv, ji = jpq.search(j, qs, 10, n_probes=8, backend="pallas")
    port = _carried(j)
    st = {}
    tv, ti = tpq.search(port, qs, 10, n_probes=8, backend="pallas",
                        device=CPU, stats=st)
    assert st["qpl_cap"] > _initial_cap(128, 8, 64)
    assert st["attempts"][0]["dropped"] == 0 and len(st["attempts"]) == 1
    verdict = _agree(jv, ji, tv, ti, rtol=5e-4,
                     atol=5e-4 * float(np.abs(np.asarray(jv)).max()))
    assert verdict["ok"], verdict
    row_bytes = port.pq_dim * port.n_codes * 2
    small = tpq.Resources(device=CPU, workspace_bytes=48 * (
        8 * port.max_list_size * 4 + row_bytes))
    st2 = {}
    tiled = tpq.search(port, qs, 10, n_probes=8, backend="pallas", res=small,
                       stats=st2)
    assert st2["q_tile"] == 48 and st2["tiles"] == 3
    assert all(torch.equal(a, b) for a, b in zip((tv, ti), tiled))


@pytest.mark.parametrize("q,ws,want", [
    (10_000, 1 << 30, 3744),         # the streamed path at the default
    (10_000, 64 << 20, 234),         # the workspace binds
    (100, 1 << 30, 100),             # the batch is smaller than both
    (10_000, 1, 1)])
def test_pallas_q_tile(q, ws, want):
    assert tpq.pallas_q_tile(q, 16, 3968, 64 * 256 * 2, ws) == want


RESOLVER = [
    # (backend, device, max_list_size, k, kind, cache_only) → expected
    (("auto", "cuda", 1024, 10, "subspace", False), "ragged"),
    (("auto", "cuda", 1024, 600, "subspace", False), "pallas"),
    (("auto", "cuda", 3968, 10, "subspace", False), "pallas"),
    (("auto", "cuda", 1536, 10, "subspace", False), "pallas"),
    (("auto", "cuda", 3968, 10, "cluster", False), "gather"),
    (("auto", "cuda", 2048, 10, "cluster", False), "ragged"),
    (("auto", "cuda", 960, 10, "subspace", False), "gather"),
    (("auto", "cpu", 1024, 10, "subspace", False), "gather"),
    (("auto", "cpu", 3968, 10, "cluster", False), "gather"),
    (("auto", "cpu", 2048, 10, "subspace", True), "ragged"),
    (("auto", "cuda", 2048, 10, "subspace", True), "ragged"),
    (("ragged", "cpu", 2048, 10, "subspace", True), "ragged"),
    (("pallas", "cpu", 3968, 10, "subspace", False), "pallas"),
    (("gather", "cuda", 1024, 10, "cluster", False), "gather"),
    (("ragged", "cuda", 3968, 10, "subspace", False), "ragged"),
    (("pallas", "cuda", 3968, 10, "cluster", False), ValueError),
    (("pallas", "cpu", 1024, 10, "cluster", False), ValueError),
    (("auto", "cuda", 1536, 10, "subspace", True), ValueError),
    (("pallas", "cuda", 2048, 10, "subspace", True), ValueError),
    (("gather", "cpu", 2048, 10, "subspace", True), ValueError),
    (("jnp", "cpu", 1024, 10, "subspace", False), ValueError),
]


@pytest.mark.parametrize("args,want", RESOLVER)
def test_backend_resolver_table(args, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            tpq.resolve_backend(*args)
    else:
        assert tpq.resolve_backend(*args) == want


def test_pallas_on_a_cluster_index_raises(data, jax_cluster):
    port = _carried(jax_cluster)
    with pytest.raises(ValueError, match="per-cluster"):
        tpq.search(port, data[1][:4], 5, backend="pallas", device=CPU)
    st = {}
    tpq.search(port, data[1][:4], 5, device=CPU, stats=st)
    assert st["backend"] == "gather"


def _recall(idx, data, gt, backend, kf=40, n_probes=8, torch_side=True):
    ds, qs = data
    if torch_side:
        _, cand = tpq.search(idx, qs, kf, n_probes=n_probes, backend=backend,
                             device=CPU)
        v, i = trf.refine(ds, qs, cand, 10, device=CPU)
        return tmet.neighborhood_recall(i, _t(gt[1]), v, _t(gt[0]))
    _, cand = jpq.search(idx, qs, kf, n_probes=n_probes, backend=backend)
    v, i = jref.refine(ds, qs, cand, 10)
    return float(jmet.neighborhood_recall(i, gt[1], v, gt[0]))


def _stream_invariants(idx, n, group):
    ids = idx.list_ids[idx.list_ids >= 0]
    assert idx.size + idx._streaming_dropped == n
    assert torch.equal(ids.sort().values, torch.unique(ids))   # each id once
    assert idx.max_list_size % group == 0 and idx.group_size == group
    if group == 512:
        chunks = idx.max_list_size // 512
        assert chunks & (chunks - 1) == 0                        # pow2
    assert set(idx.build_timings_s) == {"train", "assign", "encode"}


N_STREAM = 10_000      # the streamed builds' rows: the first of the data


@pytest.fixture(scope="module")
def stream_data(data):
    ds, qs = data
    v, i = jbf.search(jbf.build(ds[:N_STREAM]), qs, 10)
    return (ds[:N_STREAM], qs), (np.array(v), np.array(i))


STREAM = dict(n_lists=32, pq_dim=16, pq_bits=8, kmeans_trainset_fraction=0.5,
              kmeans_n_iters=8, codebook_n_iters=8)


@pytest.mark.parametrize("store,group", [("codes", 128), ("codes", 512),
                                         ("cache", 512)])
def test_build_streaming_invariants_and_recall(stream_data, store, group):
    data, gt = stream_data
    ds = data[0]
    params = dict(STREAM, group_size=group)
    port = tpq.build_streaming(lambda s, e: ds[s:e], N_STREAM, 32,
                               tpq.IvfPqParams(**params), device=CPU,
                               chunk_rows=3_000, store=store)
    _stream_invariants(port, N_STREAM, group)
    assert port._streaming_dropped == 0              # the auto cap holds all
    assert torch.equal(port.list_ids[port.list_ids >= 0].sort().values,
                       torch.arange(N_STREAM, dtype=torch.int32))
    assert torch.isinf(port.b_sum[port.list_ids < 0]).all()
    assert port.cache_only == (store == "cache")
    jidx = jpq.build_streaming(lambda s, e: ds[s:e], N_STREAM, 32,
                               jpq.IvfPqParams(**params), chunk_rows=3_000,
                               store=store)
    # the builds are compared, each through its cheapest exact route: the
    # port's K5 twin beside the JAX gather backend on the 128 granule
    backend = "ragged" if group == 512 else "pallas"
    want = _recall(jidx, data, gt, "ragged" if group == 512 else "gather",
                   torch_side=False)
    got = _recall(port, data, gt, backend)
    assert abs(got - want) <= 0.02, (got, want)


def test_build_streaming_truncated_cache_and_tight_cap(stream_data):
    """cache_dim < rot_dim keeps that many rotated coordinates and searches
    through K1's twin; a cap below the mean load drops rows and counts
    them."""
    data, gt = stream_data
    ds = data[0]
    port = tpq.build_streaming(lambda s, e: ds[s:e], N_STREAM, 32,
                               tpq.IvfPqParams(**STREAM), device=CPU,
                               chunk_rows=3_000, store="cache", cache_dim=24)
    assert port.decoded.shape[-1] == 24 and port.rot_dim == 32
    assert _recall(port, data, gt, "auto") >= 0.8
    tight = tpq.build_streaming(
        lambda s, e: ds[s:e], N_STREAM, 32,
        tpq.IvfPqParams(**dict(STREAM, list_size_cap=256, group_size=128)),
        device=CPU, chunk_rows=3_000)
    _stream_invariants(tight, N_STREAM, 128)
    # a row whose two nearest lists are full is dropped, even where other
    # lists have room: at least the rows past 32 · 256 go
    assert tight._streaming_dropped >= N_STREAM - 32 * 256
    assert int(tight.list_sizes().max()) == 256
    with pytest.raises(ValueError, match="cache_dim"):
        tpq.build_streaming(lambda s, e: ds[s:e], N_STREAM, 32,
                            tpq.IvfPqParams(**STREAM), device=CPU,
                            store="cache", cache_dim=33)
    with pytest.raises(ValueError, match="subspace codebooks only"):
        tpq.build_streaming(lambda s, e: ds[s:e], N_STREAM, 32,
                            tpq.IvfPqParams(**STREAM, codebook_kind="cluster"),
                            device=CPU, store="cache")


@pytest.fixture(scope="module")
def jax_cache_index(stream_data):
    ds = stream_data[0][0]
    return jpq.build_streaming(lambda s, e: ds[s:e], N_STREAM, 32,
                               jpq.IvfPqParams(**STREAM), chunk_rows=3_000,
                               store="cache", cache_dim=24)


def test_carried_cache_only_index_searches_like_jax(data, jax_cache_index):
    _, qs = data
    jv, ji = jpq.search(jax_cache_index, qs, 20, n_probes=8)
    port = _carried(jax_cache_index)
    assert port.cache_only and port.decoded.shape[-1] == 24
    st = {}
    tv, ti = tpq.search(port, qs, 20, n_probes=8, device=CPU, stats=st)
    assert st["backend"] == "ragged"
    atol = 5e-4 * float((qs.astype(np.float64) ** 2).sum(1).max())
    verdict = _agree(jv, ji, tv, ti, rtol=5e-4, atol=atol)
    assert verdict["ok"], verdict


def test_cache_only_index_cannot_be_saved_or_extended(tmp_path, data,
                                                      jax_cache_index):
    """The index file holds codes, not the cache: the JAX package writes a
    cache-only index and loads it back as one it cannot search (ROADMAP
    Queue 3). The port refuses to write it, and extend raises in both."""
    _, qs = data
    jax_cache_index.save(tmp_path / "cache.idx")
    back = jpq.IvfPqIndex.load(tmp_path / "cache.idx")
    with pytest.raises(TypeError):
        jpq.search(back, qs[:4], 5, n_probes=4)
    port = _carried(jax_cache_index)
    with pytest.raises(ValueError, match="cache-only"):
        port.save(tmp_path / "port.idx")
    with pytest.raises(ValueError, match="cache-only"):
        tpq.extend(port, qs[:4], device=CPU)
    with pytest.raises(ValueError, match="cache-only"):
        jpq.extend(jax_cache_index, qs[:4])
    with pytest.raises(ValueError, match="decoded"):
        tpq.from_jax_arrays({"kind": "ivf_pq"}, {
            k: np.asarray(getattr(jax_cache_index, k)) for k in
            ("centers", "rotation", "codebooks", "list_codes", "list_ids",
             "b_sum")}, device=CPU)


def test_assign_top2_divert_and_unpack_bitwise():
    rng = np.random.default_rng(4)
    rows = rng.normal(size=(3000, 16)).astype(np.float32)
    centers = rng.normal(size=(40, 16)).astype(np.float32)
    for metric in ("sqeuclidean", "inner_product"):
        j1, j2 = jpk.assign_top2(jnp.asarray(rows), jnp.asarray(centers),
                                 block=16, metric=metric)
        t1, t2 = tpk.assign_top2(_t(rows), _t(centers), block=16,
                                 metric=metric)
        np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
        np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))
    run = rng.integers(40, 90, 40).astype(np.int32)
    want = jpk.divert_to_cap(j1, j2, jnp.asarray(run), jnp.int32(150), 40)
    got = tpk.divert_to_cap(t1, t2, _t(run), 150, 40)
    assert int((got == 40).sum()) > 0              # the case drops rows
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    payload = rng.integers(0, 256, (50, 7)).astype(np.uint8)
    labels = rng.integers(0, 6, 50).astype(np.int32)
    ids = rng.permutation(1000)[:50].astype(np.int32)
    jp, ji = jpk.pack_lists(jnp.asarray(payload), jnp.asarray(ids),
                            jnp.asarray(labels), 6, 16)
    want = jpk.unpack_lists(jp, ji)
    got = tpk.unpack_lists(_t(jp), _t(ji))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("bits", [4, 8])
def test_extend_matches_jax(data, jax_indexes, bits):
    ds, qs = data
    j = jax_indexes[bits]
    new = ds[:300] + 0.5
    want = jpq.extend(j, new)
    got = tpq.extend(_carried(j), new, device=CPU)
    assert got.group_size == want.group_size == 128
    np.testing.assert_array_equal(got.list_ids.numpy(),
                                  np.asarray(want.list_ids))
    np.testing.assert_array_equal(got.list_codes.numpy(),
                                  np.asarray(want.list_codes))
    np.testing.assert_allclose(got.b_sum.numpy(), np.asarray(want.b_sum),
                               rtol=1e-5, atol=1e-5 * float(
                                   np.abs(np.asarray(j.b_sum)[
                                       np.asarray(j.list_ids) >= 0]).max()))
    assert got.size == j.size + 300
    assert int(got.list_ids.max()) == 20_000 + 299       # ids max + 1 …


@pytest.mark.parametrize("kind", ["dense", "hadamard"])
def test_unrotate_and_rotation_matrix_match_jax(kind):
    rng = np.random.default_rng(7)
    if kind == "dense":
        rot = np.linalg.qr(rng.normal(size=(16, 16)))[0].astype(np.float32)
    else:
        rot = np.where(rng.random(16) < 0.5, 1.0, -1.0).astype(np.float32)
    y = rng.normal(size=(9, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tla.unrotate_rows(_t(y), _t(rot), kind).numpy(),
        np.asarray(jla.unrotate_rows(jnp.asarray(y), jnp.asarray(rot), kind)),
        rtol=1e-5, atol=1e-6)
    R = tla.rotation_matrix_of(_t(rot), kind)
    np.testing.assert_allclose(
        R.numpy(), np.asarray(jla.rotation_matrix_of(jnp.asarray(rot), kind)),
        rtol=1e-5, atol=1e-6)
    x = tla.unrotate_rows(tla.rotate_rows(_t(y), _t(rot), kind), _t(rot),
                          kind)
    np.testing.assert_allclose(x.numpy(), y, rtol=1e-4, atol=1e-5)


def test_reconstruct_rows_matches_jax_and_reencodes(data, jax_indexes):
    j = jax_indexes[4]
    port = _carried(j)
    codes, _, labels = tpk.unpack_lists(port.list_codes, port.list_ids)
    want = np.asarray(jpq.reconstruct_rows(
        j.centers, j.rotation, j.codebooks, jnp.asarray(codes.numpy()),
        jnp.asarray(labels.numpy()), j.pq_dim, j.pq_bits))
    got = tpq.reconstruct_rows(port.centers, port.rotation, port.codebooks,
                               codes, labels, port.pq_dim, port.pq_bits)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    resid = tla.rotate_rows(got - port.centers[labels.long()], port.rotation)
    again = tpq.pack_codes(tpq._encode(resid.reshape(-1, port.pq_dim, 2),
                                       port.codebooks), port.pq_bits)
    assert float((again == codes).all(dim=1).float().mean()) >= 0.999


def test_cluster_encode_b_sum_and_decode_match_jax(data, jax_cluster):
    j = jax_cluster
    port = _carried(j)
    ds = data[0][:3000]
    labels = np.asarray(jpq.kmeans_balanced.predict(ds, j.centers))
    resid = np.asarray(jpq.linalg.rotate_rows(
        jnp.asarray(ds) - j.centers[labels], j.rotation)).reshape(
        -1, j.pq_dim, 2)
    want = np.asarray(jpq._encode_cluster(jnp.asarray(resid),
                                          jnp.asarray(labels), j.codebooks))
    got = tpq._encode_cluster(_t(resid), _t(labels), port.codebooks)
    assert float((got.numpy() == want).mean()) >= 0.999
    b_want = np.asarray(jpq._compute_b_sum(
        j.centers, j.rotation, j.codebooks, j.list_codes, j.list_ids,
        "sqeuclidean", j.pq_dim, j.pq_bits, cluster=True))
    b_got = tpq._compute_b_sum(port.centers, port.rotation, port.codebooks,
                               port.list_codes, port.list_ids, "sqeuclidean",
                               port.pq_dim, port.pq_bits, cluster=True)
    np.testing.assert_allclose(b_got.numpy(), b_want, rtol=1e-5,
                               atol=1e-5 * np.abs(b_want[np.isfinite(b_want)]).max())
    c_want, s_want = jpq._decode_lists(j.codebooks, j.list_codes,
                                       pq_dim=j.pq_dim, pq_bits=j.pq_bits,
                                       cluster=True)
    c_got, s_got = tpq._decode_lists(port.codebooks, port.list_codes,
                                     port.pq_dim, port.pq_bits, cluster=True)
    assert float(s_got) == float(s_want)
    np.testing.assert_array_equal(c_got.numpy(), np.asarray(c_want))


def test_port_built_cluster_index_recall_beside_jax(data, gt, jax_cluster):
    ds, qs = data
    sub_gt = jbf.search(jbf.build(ds[:N_CLUSTER]), qs, 10)
    sub_gt = (np.array(sub_gt[0]), np.array(sub_gt[1]))
    port = tpq.build(ds[:N_CLUSTER], tpq.IvfPqParams(**CLUSTER), device=CPU)
    assert port.codebooks.shape == (16, 32, 2) and port.pq_dim == 16
    sub = (ds[:N_CLUSTER], qs)
    want = _recall(jax_cluster, sub, sub_gt, "gather", n_probes=4,
                   torch_side=False)
    got = _recall(port, sub, sub_gt, "gather", n_probes=4)
    assert abs(got - want) <= 0.02, (got, want)


def test_cluster_and_streamed_index_files_load(tmp_path, data, jax_cluster):
    """A JAX-saved per-cluster index loads (pq_dim from pq_dim_hint) and
    searches as the JAX one does; the port's file loads back in JAX."""
    _, qs = data
    jax_cluster.save(tmp_path / "cluster.idx")
    port = tpq.IvfPqIndex.load(tmp_path / "cluster.idx", device=CPU)
    assert port.codebook_kind == "cluster" and port.pq_dim == 16
    jv, ji = jpq.search(jax_cluster, qs[:50], 10, n_probes=4,
                        backend="gather")
    tv, ti = tpq.search(port, qs[:50], 10, n_probes=4, device=CPU)
    assert _agree(jv, ji, tv, ti, rtol=1e-5, atol=1e-5 * float(
        np.abs(np.asarray(jv)).max()), tie_rtol=1e-5)["ok"]
    port.save(tmp_path / "back.idx")
    back = jpq.IvfPqIndex.load(tmp_path / "back.idx")
    assert back.codebook_kind == "cluster" and back.pq_dim == 16
