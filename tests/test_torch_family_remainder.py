"""Port parity: the family remainders of raft_tpu_torch against raft_tpu on
the same numpy data — IVF-Flat and IVF-BQ ``extend`` and IVF-BQ
``reconstruct_rows`` on a JAX-built index carried across, the streamed
IVF-BQ build, ``pairwise_distance`` and brute force in every metric, and
the paged ``"auto"`` rule that sends k over 512 to the gather scans.

Tolerances: an extended index's ids and integer payloads (uint8 rows, BQ
codes) equal JAX's bit for bit, its float scalars within rtol 1e-5 (plus
1e-5 × the largest |value|: the fp32 matmuls sum in another order);
distances within rtol 1e-5 plus 1e-5 × the largest |value|; brute-force
and gather ids equal except at near-ties (1e-5 relative). The streamed
build is judged by invariants (rows placed + dropped = n, no list over its
cap, every id once) and by refined recall within 0.02 of JAX's streamed
build (the two draw their training rows and rotations from different
generators).
"""

import numpy as np
import pytest
import torch

from raft_tpu import serving as jsv
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_bq as jbq
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.ops import distance as jdist
from raft_tpu_torch import serving as tsv
from raft_tpu_torch.bench.datasets import sift_like
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import _packing
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import ivf_bq as tbq
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.ops import distance as tdist
from raft_tpu_torch.stats import metrics as tmet

torch.set_num_threads(2)
CPU = "cpu"


def np_(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float64)
    got = np_(got).astype(np.float64)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    top = float(np.abs(want[fin]).max()) if fin.any() else 0.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                               atol=rtol * top)


@pytest.fixture(scope="module")
def data():
    return sift_like(4000, 32, 120, seed=21)


def carry_flat(j):
    arrays = {k: np.asarray(getattr(j, k)) for k in
              ("centers", "list_data", "list_ids")}
    if j.list_norms is not None:
        arrays["list_norms"] = np.asarray(j.list_norms)
    return tfl.from_jax_arrays({"kind": "ivf_flat", "metric": j.metric,
                                "group_size": j.group_size}, arrays,
                               device=CPU)


def carry_bq(j):
    arrays = {k: np.asarray(getattr(j, k)) for k in
              ("centers", "rotation", "list_codes", "list_ids", "list_scale",
               "list_bias")}
    return tbq.from_jax_arrays({"kind": "ivf_bq", "metric": j.metric,
                                "bits": j.bits,
                                "rotation_kind": j.rotation_kind}, arrays,
                               device=CPU)


def carry_pq(j):
    arrays = {k: np.asarray(getattr(j, k)) for k in
              ("centers", "rotation", "codebooks", "list_codes", "list_ids",
               "b_sum")}
    return tpq.from_jax_arrays(
        {"kind": "ivf_pq", "metric": j.metric, "pq_bits": j.pq_bits,
         "group_size": j.group_size, "codebook_kind": j.codebook_kind,
         "pq_dim_hint": j.pq_dim_hint}, arrays, device=CPU)


# ---------------------------------------------------------------------------
# IVF-Flat extend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric,group,as_float", [
    ("sqeuclidean", 512, False),     # uint8 storage, the strip granule
    ("inner_product", 64, True),     # fp32 storage, the small granule
    ("cosine", 0, False),            # normalized fp32 storage, legacy group
])
def test_ivf_flat_extend_matches_jax(data, metric, group, as_float):
    ds, qs = data
    base = ds[:3000].astype(np.float32) if as_float else ds[:3000]
    j = jfl.build(base, jfl.IvfFlatParams(n_lists=8, metric=metric,
                                          group_size=group, kmeans_n_iters=5))
    t = carry_flat(j)
    new = ds[3000:]
    ids = np.arange(70_000, 70_000 + new.shape[0], dtype=np.int32)
    je = jfl.extend(j, new, ids)
    te = tfl.extend(t, new, ids, device=CPU)
    assert te.group_size == je.group_size
    np.testing.assert_array_equal(np_(te.list_ids), np.asarray(je.list_ids))
    assert te.list_data.dtype == torch.from_numpy(
        np.asarray(je.list_data)[:1]).dtype
    if te.list_data.dtype == torch.uint8:
        np.testing.assert_array_equal(np_(te.list_data),
                                      np.asarray(je.list_data))
    else:
        close(te.list_data, je.list_data)
    if je.list_norms is not None:
        close(te.list_norms, je.list_norms)
    # default ids continue after the largest
    je2 = jfl.extend(j, new[:5])
    te2 = tfl.extend(t, new[:5], device=CPU)
    np.testing.assert_array_equal(np_(te2.list_ids), np.asarray(je2.list_ids))


def test_ivf_flat_extend_reads_back_through_the_strip_scan(data):
    ds, qs = data
    t = tfl.build(ds[:3000], tfl.IvfFlatParams(n_lists=8, group_size=512,
                                               kmeans_n_iters=5), device=CPU)
    new = ds[3000:3100]
    te = tfl.extend(t, new, np.arange(10_000, 10_100), device=CPU)
    _, ids = tfl.search(te, new, 1, n_probes=8, backend="ragged", device=CPU)
    assert (np_(ids)[:, 0] == np.arange(10_000, 10_100)).all()


def test_ivf_flat_extend_rounds_floats_into_integer_storage(data, caplog):
    ds, _ = data
    t = tfl.build(ds[:3000], tfl.IvfFlatParams(n_lists=8, kmeans_n_iters=5),
                  device=CPU)
    assert t.list_data.dtype == torch.uint8
    rows = ds[:4].astype(np.float32) + 0.25
    rows[0, 0] = 300.0                            # clipped to 255
    te = tfl.extend(t, rows, device=CPU)
    assert te.list_data.dtype == torch.uint8
    assert "loses up to" in caplog.text


# ---------------------------------------------------------------------------
# IVF-BQ extend and reconstruct_rows
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bq_pair(data):
    ds = data[0].astype(np.float32)
    j = jbq.build(ds[:3000], jbq.IvfBqParams(n_lists=8, kmeans_n_iters=5))
    return j, carry_bq(j)


@pytest.mark.parametrize("metric,bits,rotation_kind", [
    ("sqeuclidean", 1, "dense"), ("inner_product", 2, "hadamard"),
    ("cosine", 4, "dense")])
def test_ivf_bq_extend_matches_jax(data, metric, bits, rotation_kind):
    ds = data[0].astype(np.float32)
    j = jbq.build(ds[:3000], jbq.IvfBqParams(
        n_lists=8, metric=metric, bits=bits, rotation_kind=rotation_kind,
        kmeans_n_iters=5))
    new = ds[3000:]
    je = jbq.extend(j, new)
    te = tbq.extend(carry_bq(j), new, device=CPU)
    np.testing.assert_array_equal(np_(te.list_ids), np.asarray(je.list_ids))
    np.testing.assert_array_equal(np_(te.list_codes),
                                  np.asarray(je.list_codes))
    close(te.list_scale, je.list_scale)
    close(te.list_bias, je.list_bias)


def test_ivf_bq_extend_reads_back_after_refine(data, bq_pair):
    ds, _ = data
    ds = ds.astype(np.float32)
    _, t = bq_pair
    new = ds[3000:3200]
    te = tbq.extend(t, new, np.arange(50_000, 50_200), device=CPU)
    full = np.concatenate([ds[:3000], np.zeros((47_000, ds.shape[1]),
                                               np.float32), new])
    _, ids = tbq.search_refined(te, full, new, 1, n_probes=8, device=CPU)
    assert (np_(ids)[:, 0] == np.arange(50_000, 50_200)).mean() >= 0.99


@pytest.mark.parametrize("bits,rotation_kind", [(1, "dense"), (2, "dense"),
                                                (4, "hadamard")])
def test_ivf_bq_reconstruct_rows_matches_jax(data, bits, rotation_kind):
    ds = data[0].astype(np.float32)[:2000]
    j = jbq.build(ds, jbq.IvfBqParams(n_lists=8, bits=bits,
                                      rotation_kind=rotation_kind,
                                      kmeans_n_iters=5))
    t = carry_bq(j)
    codes, ids, labels = _packing.unpack_lists(t.list_codes, t.list_ids)
    scale, _, _ = _packing.unpack_lists(t.list_scale, t.list_ids)
    want = jbq.reconstruct_rows(j.centers, j.rotation, np_(codes),
                                np_(scale), np_(labels), bits, rotation_kind)
    got = tbq.reconstruct_rows(t.centers, t.rotation, codes, scale, labels,
                               bits, rotation_kind)
    close(got, want)
    # the reconstruction lands near its row: closer than the list center
    x = torch.from_numpy(ds)[ids.long()]
    err = (got - x).norm(dim=1)
    off = (t.centers[labels.long()] - x).norm(dim=1)
    assert float((err < off).float().mean()) >= 0.9


# ---------------------------------------------------------------------------
# IVF-BQ streamed build
# ---------------------------------------------------------------------------

def _recall(out, gt):
    v, i = (torch.as_tensor(np.array(x)) for x in out)
    return tmet.neighborhood_recall(i, torch.from_numpy(gt[1]), v,
                                    torch.from_numpy(gt[0]))


def _check_streamed(index, n, cap=None):
    ids = np_(index.list_ids)
    placed = ids[ids >= 0]
    assert placed.shape[0] + index._streaming_dropped == n
    assert np.unique(placed).shape[0] == placed.shape[0]
    if cap:
        assert int((ids >= 0).sum(axis=1).max()) <= cap
    assert (np_(index.list_bias)[ids < 0] == np.inf).all()
    assert (np_(index.list_scale)[ids < 0] == 0).all()
    assert set(index.build_timings_s) == {"train", "assign", "encode"}


def test_ivf_bq_build_streaming_invariants_and_recall_beside_jax():
    ds, qs = sift_like(12_000, 32, 200, seed=22)
    ds, qs = ds.astype(np.float32), qs.astype(np.float32)
    gtv, gti = jbf.search(jbf.build(ds), qs, 10)
    gt = (np.array(gtv), np.array(gti))
    params = dict(n_lists=16, kmeans_n_iters=10)
    jidx = jbq.build_streaming(lambda s, e: ds[s:e], ds.shape[0], 32,
                               jbq.IvfBqParams(**params), chunk_rows=3000)
    tidx = tbq.build_streaming(lambda s, e: ds[s:e], ds.shape[0], 32,
                               tbq.IvfBqParams(**params), chunk_rows=3000,
                               device=CPU)
    _check_streamed(tidx, ds.shape[0],
                    _packing.auto_list_cap(ds.shape[0], 16, 512))
    assert tidx._streaming_dropped == jidx._streaming_dropped == 0
    want = _recall(jbq.search_refined(jidx, ds, qs, 10, n_probes=4), gt)
    got = _recall(tbq.search_refined(tidx, ds, qs, 10, n_probes=4,
                                     device=CPU), gt)
    assert abs(got - want) <= 0.02, (got, want)
    assert got >= 0.8


def test_ivf_bq_build_streaming_counts_what_a_tight_cap_drops():
    """A cap that forces drops: every row is placed or counted, no list
    passes the cap, and the diversion is the JAX package's (the same
    centers and labels give the same placement)."""
    ds, _ = sift_like(6000, 32, 10, seed=23)
    ds = ds.astype(np.float32)
    params = tbq.IvfBqParams(n_lists=16, kmeans_n_iters=5, list_size_cap=400)
    idx = tbq.build_streaming(lambda s, e: ds[s:e], ds.shape[0], 32, params,
                              chunk_rows=1500, device=CPU)
    _check_streamed(idx, ds.shape[0], 400)
    assert idx._streaming_dropped > 0


def test_ivf_bq_streamed_codes_equal_the_one_shot_encode():
    """Pass 2's chunked encode and offset scatter write what one encode of
    the same rows and labels writes, row for row."""
    ds, _ = sift_like(3000, 32, 10, seed=24)
    ds = ds.astype(np.float32)
    idx = tbq.build_streaming(lambda s, e: ds[s:e], ds.shape[0], 32,
                              tbq.IvfBqParams(n_lists=8, kmeans_n_iters=5),
                              chunk_rows=700, device=CPU)
    codes, ids, labels = _packing.unpack_lists(idx.list_codes, idx.list_ids)
    scale, _, _ = _packing.unpack_lists(idx.list_scale, idx.list_ids)
    want = tbq._encode_rows(torch.from_numpy(ds)[ids.long()], labels,
                            idx.centers, idx.rotation, idx.metric)
    assert torch.equal(codes, want[0])
    torch.testing.assert_close(scale, want[1], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# pairwise_distance and brute force, every metric
# ---------------------------------------------------------------------------

ALL = sorted(jdist.ALL_METRICS)


def test_metric_names_and_aliases_match_jax():
    assert tdist.ALL_METRICS == jdist.ALL_METRICS
    assert tdist.EXPANDED_METRICS == jdist.EXPANDED_METRICS
    for alias in ("l2", "cityblock", "manhattan", "linf", "lp", "ip", "kl",
                  "jensen-shannon", "l2sqrtexpanded", "taxicab", "dot"):
        assert tdist.canonical_metric(alias) == jdist.canonical_metric(alias)
    with pytest.raises(ValueError, match="unknown metric"):
        tdist.canonical_metric("l7")


def _metric_inputs(metric, rng, m=40, n=300, k=16):
    if metric == "haversine":
        return (rng.uniform(-1.5, 1.5, (m, 2)).astype(np.float32),
                rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32))
    if metric in ("hellinger", "jensenshannon", "kl_divergence"):
        x = rng.random((m, k)).astype(np.float32) + 0.01
        y = rng.random((n, k)).astype(np.float32) + 0.01
        return x / x.sum(1, keepdims=True), y / y.sum(1, keepdims=True)
    if metric in ("hamming", "russellrao", "jaccard", "dice"):
        return ((rng.random((m, k)) < 0.4).astype(np.float32),
                (rng.random((n, k)) < 0.4).astype(np.float32))
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((n, k)).astype(np.float32))


@pytest.mark.parametrize("metric", ALL)
def test_pairwise_distance_matches_jax(metric):
    rng = np.random.default_rng(len(metric))
    x, y = _metric_inputs(metric, rng)
    p = 3.0
    want = jdist.pairwise_distance(x, y, metric, p=p)
    got = tdist.pairwise_distance(x, y, metric, p=p, device=CPU)
    close(got, want)
    # row tiles of the elementwise metrics change nothing but the order of
    # vectorised float ops
    tiled = tdist.pairwise_distance(x, y, metric, p=p, res=Resources(
        device=CPU, workspace_bytes=y.size * 4 * 7))
    torch.testing.assert_close(tiled, got, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("metric", ALL)
def test_brute_force_every_metric_matches_jax(metric):
    rng = np.random.default_rng(100 + len(metric))
    q, ds = _metric_inputs(metric, rng, m=30, n=900)
    jv, ji = jbf.search(jbf.build(ds, metric, 3.0), q, 7, tile_rows=256)
    tv, ti = tbf.search(tbf.build(ds, metric, 3.0, device=CPU), q, 7,
                        tile_rows=256, device=CPU)
    jv, ji = np.asarray(jv), np.asarray(ji)
    close(tv, jv)
    tie = np.abs(np_(tv) - jv) <= 1e-5 * (np.abs(jv) + 1e-6) + 1e-6
    diff = np_(ti) != ji
    # binary inputs tie often: a different id only where the values tie
    assert not (diff & ~tie).any()
    want = jbf.knn(q, ds, 3, metric=metric, metric_arg=3.0)
    got = tbf.knn(q, ds, 3, metric=metric, metric_arg=3.0, device=CPU)
    close(got[0], want[0])


# ---------------------------------------------------------------------------
# The paged "auto" rule: k over 512 goes to the gather scans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stores(data):
    ds, _ = data
    jf = jfl.build(ds, jfl.IvfFlatParams(n_lists=8, kmeans_n_iters=5))
    jq = jpq.build(ds.astype(np.float32), jpq.IvfPqParams(
        n_lists=8, pq_dim=16, kmeans_n_iters=5))
    jb = jbq.build(ds.astype(np.float32), jbq.IvfBqParams(n_lists=8,
                                                          kmeans_n_iters=5))
    out = {}
    for kind, j, t in (("flat", jf, carry_flat(jf)), ("pq", jq, carry_pq(jq)),
                       ("bq", jb, carry_bq(jb))):
        out[kind] = (jsv.PagedListStore.from_index(j, page_rows=64),
                     tsv.PagedListStore.from_index(t, page_rows=64,
                                                   device=CPU))
    return out


@pytest.mark.parametrize("k", [600, 1000])
@pytest.mark.parametrize("kind", ["flat", "pq"])
def test_paged_auto_takes_the_gather_scan_past_k3(data, stores, kind, k):
    """Where K3's plan cannot feed k (here k > 512) the port's "auto" takes
    the gather scan and serves, as JAX's does (its "auto" is the gather
    scan off the TPU); before, the port raised."""
    _, qs = data
    jst, tst = stores[kind]
    jmod, tmod = {"flat": (jfl, tfl), "pq": (jpq, tpq)}[kind]
    assert tsv.paged_engine(tst, k) == "gather"
    assert tsv.paged_engine(tst, 10) == "paged"
    jv, ji = jmod.search_paged(jst, qs, k, n_probes=4)
    tv, ti = tmod.search_paged(tst, qs, k, n_probes=4, device=CPU)
    verdict = tmet.topk_agreement(torch.from_numpy(np.array(jv)),
                                  torch.from_numpy(np.array(ji)), tv, ti,
                                  rtol=1e-5, atol=0.0, tie_rtol=1e-5)
    assert verdict["ok"], verdict
    with pytest.raises(ValueError, match=f"cannot serve k={k}"):
        tmod.search_paged(tst, qs, k, n_probes=4, backend="paged",
                          device=CPU)


def test_paged_bq_past_k4_raises_as_jax_does(data, stores):
    _, qs = data
    jst, tst = stores["bq"]
    with pytest.raises(ValueError, match="k=600 out of range"):
        jbq.search_paged(jst, qs, 600, n_probes=4)
    with pytest.raises(ValueError, match="k=600 out of range"):
        tbq.search_paged(tst, qs, 600, n_probes=4, device=CPU)
    # a store whose pages K4's plan cannot take: "auto" names why
    small = tsv.PagedListStore.from_index(carry_bq(jbq.build(
        data[0][:1000].astype(np.float32), jbq.IvfBqParams(
            n_lists=4, kmeans_n_iters=3))), page_rows=4, device=CPU)
    with pytest.raises(ValueError, match="page_rows >= 8"):
        tbq.search_paged(small, qs, 10, n_probes=4, device=CPU)
    v, i = tbq.search_paged(small, qs, 4, n_probes=4, backend="paged_jnp",
                            device=CPU)
    assert tuple(i.shape) == (qs.shape[0], 4) and (i >= 0).all()
