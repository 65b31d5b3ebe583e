"""Port parity: raft_tpu_torch.serving (PagedListStore and the three paged
searches) against raft_tpu.serving on the same numpy data.

Stores are made from a JAX-built index carried across, on both sides.
Then the same mutation sequence runs on both: a reserve, an upsert with
given ids, one with automatic ids, a replace by id, a delete, a compact and
a compact_swap. The coarse labels of every upsert batch must agree first
(a near-tie of the coarse distance could send a row to another list;
the count is asserted 0 on this data), then the pools and tables.

Bitwise: the flat store's pools and tables (uint8 payload, integer norms),
and every table, id pool and code pool. The PQ and BQ stores' float pools
are held at rtol 1e-5: the per-list constant ‖R·c_l‖² and a fresh
row's encoder scalars come from fp32 matmuls whose sums run in another
order in the two packages.

Searches: the port's paged search (the plain twins of K3 / K4 on a CPU
store) against JAX ``search_paged(backend="paged_pallas")``, the paged
Pallas kernels in interpret mode: values allclose at rtol 5e-4 (with the
L2 absolute term of test_torch_ivf_flat), ids equal except at near-ties.
"""

import numpy as np
import pytest
import torch

from raft_tpu import serving as jsv
from raft_tpu.neighbors import ivf_bq as jbq
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import serving as tsv
from raft_tpu_torch.bench.datasets import sift_like
from raft_tpu_torch.neighbors import ivf_bq as tbq
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.stats import metrics as tmet

torch.set_num_threads(2)
CPU = "cpu"


@pytest.fixture(scope="module")
def data():
    return sift_like(4000, 32, 120, seed=5)


def np_(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def carry_flat(jidx):
    arrays = {k: np.asarray(getattr(jidx, k)) for k in
              ("centers", "list_data", "list_ids")}
    if jidx.list_norms is not None:
        arrays["list_norms"] = np.asarray(jidx.list_norms)
    return tfl.from_jax_arrays({"kind": "ivf_flat", "metric": jidx.metric,
                                "group_size": jidx.group_size}, arrays,
                               device=CPU)


def carry_pq(jidx):
    arrays = {k: np.asarray(getattr(jidx, k)) for k in
              ("centers", "rotation", "codebooks", "list_codes", "list_ids",
               "b_sum")}
    return tpq.from_jax_arrays(
        {"kind": "ivf_pq", "metric": jidx.metric, "pq_bits": jidx.pq_bits,
         "group_size": jidx.group_size, "codebook_kind": jidx.codebook_kind,
         "pq_dim_hint": jidx.pq_dim_hint}, arrays, device=CPU)


def carry_bq(jidx):
    arrays = {k: np.asarray(getattr(jidx, k)) for k in
              ("centers", "rotation", "list_codes", "list_ids", "list_scale",
               "list_bias")}
    return tbq.from_jax_arrays(
        {"kind": "ivf_bq", "metric": jidx.metric, "bits": jidx.bits,
         "rotation_kind": jidx.rotation_kind}, arrays, device=CPU)


EXACT_POOLS = ("pages", "page_ids")


def assert_pools(jst, tst, float_rtol=None):
    """Pools and host tables equal: bitwise, or the float pools within
    ``float_rtol`` (inf where inf)."""
    for name in ("pages", "page_ids", "page_aux", "page_bias", "page_cache",
                 "page_scale"):
        j, t = getattr(jst, name), getattr(tst, name)
        if j is None:
            assert t is None, name
            continue
        j, t = np.asarray(j), np_(t)
        assert j.shape == t.shape and j.dtype == t.dtype, name
        if float_rtol is None or name in EXACT_POOLS or j.dtype != np.float32:
            np.testing.assert_array_equal(t, j, err_msg=name)
        else:
            np.testing.assert_allclose(t, j, rtol=float_rtol, err_msg=name)
    for name in ("_table", "_list_pages", "_fill", "_page_list"):
        np.testing.assert_array_equal(getattr(tst, name), getattr(jst, name),
                                      err_msg=name)
    assert jst._free == tst._free and jst._id_loc == tst._id_loc
    assert (jst.size, jst.tombstones, jst.growth_events) == \
        (tst.size, tst.tombstones, tst.growth_events)


def labels_agree(jst, tst, vecs):
    work = vecs.astype(np.float32)
    if jst.metric == "cosine":
        work = work / np.maximum(np.linalg.norm(work, axis=1, keepdims=True),
                                 1e-30)
    want = np.asarray(jst._assign_labels(np.asarray(work)))
    got = tst._assign_labels(torch.from_numpy(work))
    return int((want != got).sum())


def mutate_both(jst, tst, ds, qs):
    """The mutation sequence on both stores; returns (live upserted ids,
    their query rows, deleted ids)."""
    for st in (jst, tst):
        st.reserve(400)
    new_a, new_b = qs[:40], qs[40:70]
    assert labels_agree(jst, tst, new_a) == 0
    assert labels_agree(jst, tst, new_b) == 0
    ids_a = np.arange(100_000, 100_040)
    for st in (jst, tst):
        st.upsert(new_a, ids=ids_a)
    for st in (jst, tst):
        r = st.upsert(new_b)                         # automatic ids
        assert r["upserts"] == 30
    auto_ids = np.arange(100_040, 100_070)
    for st in (jst, tst):                            # replace by id
        assert st.upsert(new_a[:5][::-1], ids=ids_a[:5])["replaced"] == 5
    deleted = np.concatenate([np.arange(0, 300, 3), ids_a[35:]])
    for st in (jst, tst):
        assert st.delete(deleted) == len(deleted)
    live_ids = np.concatenate([ids_a[:35], auto_ids])
    rows = np.concatenate([new_a[:5][::-1], new_a[5:35], new_b])
    return live_ids, rows, deleted


@pytest.fixture(scope="module")
def flat_pair(data):
    ds, _ = data
    jidx = jfl.build(ds, jfl.IvfFlatParams(n_lists=16, group_size=512,
                                           kmeans_n_iters=10))
    return jidx, carry_flat(jidx)


@pytest.mark.parametrize("page_rows", [8, 32, 64])
def test_from_index_pools_are_bitwise_the_jax_store(flat_pair, page_rows):
    jidx, tidx = flat_pair
    jst = jsv.PagedListStore.from_index(jidx, page_rows=page_rows)
    tst = tsv.PagedListStore.from_index(tidx, page_rows=page_rows,
                                        device=CPU)
    assert_pools(jst, tst)
    assert tst.stats() == {k: v for k, v in jst.stats().items()}


def agree(qs, metric, jax_out, port_out):
    atol = 0.0
    if metric in ("sqeuclidean", "euclidean"):
        atol = 5e-4 * float((qs.astype(np.float64) ** 2).sum(1).max())
    jv, ji = (torch.from_numpy(np.array(x)) for x in jax_out)
    verdict = tmet.topk_agreement(jv, ji, *port_out, rtol=5e-4, atol=atol,
                                  tie_rtol=1e-3)
    assert verdict["ok"], verdict


def test_flat_mutation_sequence_matches_jax(flat_pair, data):
    ds, qs = data
    jidx, tidx = flat_pair
    jst = jsv.PagedListStore.from_index(jidx, page_rows=32)
    tst = tsv.PagedListStore.from_index(tidx, page_rows=32, device=CPU)
    live_ids, rows, deleted = mutate_both(jst, tst, ds, qs)
    assert_pools(jst, tst)
    growth = tst.growth_events

    # every acknowledged upsert is found by its own query; no deleted id
    # comes back
    v, i = tsv.search(tst, rows, 10, n_probes=4, device=CPU)
    assert torch.equal(i[:, 0], torch.from_numpy(live_ids).to(torch.int32))
    assert not np.isin(np_(i), deleted).any()
    agree(rows, "sqeuclidean",
          jfl.search_paged(jst, rows, 10, n_probes=4, backend="paged_pallas"),
          (v, i))
    assert tst.growth_events == growth                # searches grow nothing

    # compact: the same packed arrays as JAX's, and the packed search
    # (K1's twin) finds what the paged one found
    version = tst.mutation_version
    jc, tc = jst.compact(), tst.compact()
    for name, t in tc.arrays().items():
        np.testing.assert_array_equal(np_(t), np.asarray(getattr(jc, name)),
                                      err_msg=name)
    vc, ic = tfl.search(tc, rows, 10, n_probes=4, backend="ragged",
                        device=CPU)
    assert torch.equal(ic, i) and torch.equal(vc, v)

    cap, width = tst.capacity_pages, tst.table_width
    assert jst.compact_swap(jc, jst.mutation_version)
    assert tst.compact_swap(tc, version)
    assert (tst.capacity_pages, tst.table_width) == (cap, width)
    assert tst.tombstones == 0 and tst.size == tc.size
    assert_pools(jst, tst)
    vs, is_ = tsv.search(tst, rows, 10, n_probes=4, device=CPU)
    assert torch.equal(is_, i) and torch.equal(vs, v)
    # a swap against a stale version is refused and changes nothing
    tst.upsert(qs[100:101])
    assert not tst.compact_swap(tc, version)


@pytest.mark.parametrize("metric", ["euclidean", "inner_product", "cosine"])
def test_flat_paged_search_matches_jax(data, metric):
    ds, qs = data
    jidx = jfl.build(ds, jfl.IvfFlatParams(n_lists=16, group_size=512,
                                           kmeans_n_iters=5, metric=metric))
    jst = jsv.PagedListStore.from_index(jidx, page_rows=64)
    tst = tsv.PagedListStore.from_index(carry_flat(jidx), page_rows=64,
                                        device=CPU)
    jout = jfl.search_paged(jst, qs, 10, n_probes=3, backend="paged_pallas")
    tout = tsv.search(tst, qs, 10, n_probes=3, device=CPU)
    agree(qs, metric, jout, tout)


@pytest.fixture(scope="module")
def pq_pair(data):
    ds, _ = data
    jidx = jpq.build(ds, jpq.IvfPqParams(n_lists=16, pq_dim=16,
                                         group_size=512, kmeans_n_iters=5,
                                         codebook_n_iters=5))
    return jidx, carry_pq(jidx)


def test_pq_store_and_paged_search_match_jax(pq_pair, data):
    ds, qs = data
    jidx, tidx = pq_pair
    jst = jsv.PagedListStore.from_index(jidx, page_rows=64)
    tst = tsv.PagedListStore.from_index(tidx, page_rows=64, device=CPU)
    assert_pools(jst, tst, float_rtol=1e-5)
    live_ids, rows, deleted = mutate_both(jst, tst, ds, qs)
    assert_pools(jst, tst, float_rtol=1e-5)
    jout = jpq.search_paged(jst, rows, 20, n_probes=4, backend="paged_pallas")
    v, i = tsv.search(tst, rows, 20, n_probes=4, device=CPU)
    agree(rows, "sqeuclidean", jout, (v, i))
    found = (i == torch.from_numpy(live_ids)[:, None]).any(1)
    assert float(found.float().mean()) >= 0.99
    assert not np.isin(np_(i), deleted).any()
    # the paged scan of the carried rows is the packed scan
    jst2 = tsv.PagedListStore.from_index(tidx, page_rows=64, device=CPU)
    pv, pi = tpq.search(tidx, qs, 20, n_probes=4, backend="ragged",
                        device=CPU)
    sv, si = tsv.search(jst2, qs, 20, n_probes=4, device=CPU)
    assert tmet.topk_agreement(pv, pi, sv, si)["ok"]
    tc = tst.compact()
    jc = jst.compact()
    for name in ("list_codes", "list_ids"):
        np.testing.assert_array_equal(np_(getattr(tc, name)),
                                      np.asarray(getattr(jc, name)))


def test_bq_store_and_paged_search_match_jax(data):
    ds, qs = data
    jidx = jbq.build(ds, jbq.IvfBqParams(n_lists=16, kmeans_n_iters=5))
    tidx = carry_bq(jidx)
    jst = jsv.PagedListStore.from_index(jidx, page_rows=32)
    tst = tsv.PagedListStore.from_index(tidx, page_rows=32, device=CPU)
    assert_pools(jst, tst)
    live_ids, rows, deleted = mutate_both(jst, tst, ds, qs)
    assert_pools(jst, tst, float_rtol=1e-5)
    jout = jbq.search_paged(jst, rows, 40, n_probes=4, backend="paged_pallas")
    v, i = tsv.search(tst, rows, 40, n_probes=4, device=CPU)
    agree(rows, "sqeuclidean", jout, (v, i))
    found = (i == torch.from_numpy(live_ids)[:, None]).any(1)
    assert float(found.float().mean()) >= 0.99
    assert not np.isin(np_(i), deleted).any()
    tc, jc = tst.compact(), jst.compact()
    for name in ("list_codes", "list_ids"):
        np.testing.assert_array_equal(np_(getattr(tc, name)),
                                      np.asarray(getattr(jc, name)))
    np.testing.assert_allclose(np_(tc.list_scale), np.asarray(jc.list_scale),
                               rtol=1e-5)


def test_reserved_window_does_not_grow(flat_pair, data):
    _, qs = data
    _, tidx = flat_pair
    st = tsv.PagedListStore.from_index(tidx, page_rows=32, device=CPU)
    st.reserve(8 * 12)
    g = st.growth_events
    shapes = (st.capacity_pages, st.table_width)
    for r in range(8):
        st.upsert(qs[r * 12:(r + 1) * 12], ids=np.arange(r * 12, r * 12 + 12)
                  + 50_000)
        if r >= 2:
            st.delete(np.arange((r - 2) * 12, (r - 1) * 12) + 50_000)
    assert st.growth_events == g
    assert (st.capacity_pages, st.table_width) == shapes
    assert st.stats()["tombstones"] == 6 * 12


def test_search_paged_rules(flat_pair, data):
    _, qs = data
    jidx, tidx = flat_pair
    st = tsv.PagedListStore.from_index(tidx, page_rows=8, device=CPU)
    assert tsv.paged_engine(st, 10) == "paged"
    # the gather backend serves what K3's plan cannot feed (k > 512)
    assert tsv.paged_engine(st, 600) == "gather"
    vg, ig = tsv.search(st, qs, 10, backend="gather", device=CPU)
    vp, ip = tsv.search(st, qs, 10, device=CPU)
    assert tmet.topk_agreement(vg, ig, vp, ip, rtol=5e-4,
                               atol=5e-4 * float((qs.astype(np.float64) ** 2)
                                                 .sum(1).max()))["ok"]
    with pytest.raises(ValueError, match="expected an ivf_pq store"):
        tpq.search_paged(st, qs, 10, device=CPU)
    with pytest.raises(ValueError, match="cannot serve k=600"):
        tsv.search(st, qs, 600, n_probes=16, backend="paged", device=CPU)
    v, i = tsv.search(st, qs, 600, n_probes=16, device=CPU)
    assert tuple(i.shape) == (qs.shape[0], 600) and (i[:, :10] >= 0).all()
    run = tsv.searcher(st, 5, n_probes=2, device=CPU)
    v, i = run(qs[:3])
    assert tuple(i.shape) == (3, 5)
