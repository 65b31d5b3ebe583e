"""Port parity: filtered search of raft_tpu_torch against raft_tpu on the
same numpy data — the bitset, the widening and bias rules, then every
family's filtered search on a JAX-built index carried across.

Both packages test the same ids: each mask becomes a JAX ``Bitset``, whose
words are carried into the port's (``Bitset.from_numpy_words``). The masks
are JAX's own test classes (``tests/test_filtering.py``'s ``_masks``): a
random half, all pass, all fail, and every row of one list dead (whole
dead sub-blocks, which K1–K4's plans skip). The JAX side runs as its own
tests run it: ``backend="ragged"`` / ``"pallas"`` / ``"paged_pallas"`` in
Pallas interpret mode, ``"gather"``, IVF-BQ's ``"reference"``.

Tolerances: values within rtol 5e-4 on the bf16 strip paths (plus, for
L2, an absolute 5e-4·max‖q‖²: the scan ranks scores of that size) and
1e-5 on the fp32 gather paths; ids equal except at near-ties; the ±inf
pattern (an all-fail filter: ids -1, values +inf) equal; and no returned
id ever fails its mask.
"""

import numpy as np
import pytest
import torch

from raft_tpu import serving as jsv
from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.neighbors import _filtering as jfil
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import cagra as jcg
from raft_tpu.neighbors import ivf_bq as jbq
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import serving as tsv
from raft_tpu_torch.bench.datasets import sift_like
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.neighbors import _filtering as tfil
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tcg
from raft_tpu_torch.neighbors import ivf_bq as tbq
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.stats import metrics as tmet

torch.set_num_threads(2)
CPU = "cpu"
K = 10
N_LISTS = 8
N_PROBES = 4


def np_(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def carry_bitset(jb):
    return Bitset.from_numpy_words(np.asarray(jb.bits), jb.n_bits, device=CPU)


# ---------------------------------------------------------------------------
# Bitset: every method bitwise against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_bits", [1, 31, 32, 33, 64, 257, 4096])
def test_bitset_methods_match_jax(n_bits):
    rng = np.random.default_rng(n_bits)
    mask = rng.random(n_bits) < 0.37
    mask[min(31, n_bits - 1)] = True          # bit 31 of word 0
    mask[-1] = True
    jb, tb = JBitset.from_mask(mask), Bitset.from_mask(mask, device=CPU)
    np.testing.assert_array_equal(tb.numpy_words(), np.asarray(jb.bits))
    assert torch.equal(carry_bitset(jb).bits, tb.bits)
    ids = np.array([-40, -1, 0, 1, 30, 31, 32, n_bits - 1, n_bits,
                    n_bits + 33, 1 << 20], np.int32)
    np.testing.assert_array_equal(tb.test(torch.from_numpy(ids)).numpy(),
                                  np.asarray(jb.test(ids)))
    np.testing.assert_array_equal(tb.to_mask().numpy(),
                                  np.asarray(jb.to_mask()))
    assert int(tb.popcount()) == int(jb.popcount()) == int(mask.sum())
    assert int(tb.count()) == int(jb.count())
    assert tb.pass_rate() == jb.pass_rate()
    touch = np.concatenate([rng.integers(0, n_bits, 9), [0, 0, -1]])
    for value in (True, False):
        np.testing.assert_array_equal(
            tb.set(torch.from_numpy(touch), value).numpy_words(),
            np.asarray(jb.set(touch, value).bits))
    for default in (True, False):
        jc = JBitset.create(n_bits, default)
        tc = Bitset.create(n_bits, default, device=CPU)
        np.testing.assert_array_equal(tc.numpy_words(), np.asarray(jc.bits))
        assert int(tc.popcount()) == int(jc.popcount())
        assert tc.pass_rate() == jc.pass_rate()
        np.testing.assert_array_equal(
            tc.test(torch.from_numpy(ids)).numpy(), np.asarray(jc.test(ids)))


def test_bitset_pass_rate_is_cached_and_bit31_never_sign_extends():
    b = Bitset.from_mask(np.arange(64) == 31, device=CPU)
    assert b.bits[0].item() == -(1 << 31)      # stored as int32
    got = b.test(torch.arange(-2, 66))
    assert got.nonzero().reshape(-1).tolist() == [33]   # id 31 only
    r = b.pass_rate()
    b.bits[0] = 0
    assert b.pass_rate() == r == 1 / 64


# ---------------------------------------------------------------------------
# widen_plan and apply_filter_bias
# ---------------------------------------------------------------------------

def test_widen_plan_identity_without_filter():
    for mod in (tfil, jfil):
        assert mod.widen_plan(None, 10, 64) == (10, None, 1.0, 1.0)
        assert mod.widen_plan(None, 10, 64, k_fetch=40, k_cap=512) == \
            (10, 40, 1.0, 1.0)


@pytest.mark.parametrize("n_pass,n_probes,n_lists,k_fetch,max_widen", [
    (100, 8, 64, 40, 8.0),      # 10% → 10×, capped at 8, clamped to n_lists
    (100, 2, 64, 40, None),     # the default cap
    (500, 3, 64, 100, 8.0),     # 50% → 2×
    (0, 4, 16, 40, 6.0),        # all fail: the cap, never 1/0
    (1000, 4, 16, 40, 8.0),     # all pass: identity
    (10, 4, 1024, 200, 8.0),    # k_fetch clamped to k_cap 512
])
def test_widen_plan_scales_and_clamps_like_jax(n_pass, n_probes, n_lists,
                                               k_fetch, max_widen):
    mask = np.arange(1000) < n_pass
    want = jfil.widen_plan(JBitset.from_mask(mask), n_probes, n_lists,
                           k_fetch=k_fetch, k_cap=512, max_widen=max_widen)
    got = tfil.widen_plan(Bitset.from_mask(mask, device=CPU), n_probes,
                          n_lists, k_fetch=k_fetch, k_cap=512,
                          max_widen=max_widen)
    assert got == want


def test_widen_plan_env_cap(monkeypatch):
    b = Bitset.from_mask(np.arange(1000) < 10, device=CPU)   # 1% pass
    monkeypatch.setenv(tfil.FILTER_MAX_WIDEN_ENV, "3")
    assert tfil.FILTER_MAX_WIDEN_ENV == jfil.FILTER_MAX_WIDEN_ENV
    assert tfil.default_filter_max_widen() == 3.0
    assert tfil.widen_plan(b, 4, 1024)[3] == pytest.approx(3.0)
    monkeypatch.delenv(tfil.FILTER_MAX_WIDEN_ENV)
    assert tfil.widen_plan(b, 4, 1024)[3] == pytest.approx(8.0)


def test_apply_filter_bias_rules():
    mask = np.array([True, False, True, False])
    ids = np.array([0, 1, 2, 3, -1, 7], np.int32)
    bias = np.array([1.0, 2.0, 3.0, 4.0, np.inf, 5.0], np.float32)
    want = np.asarray(jfil.apply_filter_bias(bias, ids,
                                             JBitset.from_mask(mask)))
    tb = torch.from_numpy(bias)
    got = tfil.apply_filter_bias(tb, torch.from_numpy(ids),
                                 Bitset.from_mask(mask, device=CPU))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [1.0, np.inf, 3.0, np.inf, np.inf,
                                         np.inf])
    assert tfil.apply_filter_bias(tb, torch.from_numpy(ids), None) is tb


# ---------------------------------------------------------------------------
# Filtered search against the JAX package, every family and backend
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    ds, qs = sift_like(3000, 32, 40, seed=11)
    return ds.astype(np.float32), qs.astype(np.float32)


def _masks(n, dead_ids, seed=7):
    rng = np.random.default_rng(seed)
    dead = np.ones(n, bool)
    dead[dead_ids] = False
    return {"random50": rng.random(n) < 0.5, "all_pass": np.ones(n, bool),
            "all_fail": np.zeros(n, bool), "list_dead": dead}


MASKS = ("random50", "all_pass", "all_fail", "list_dead")


def _dead_list_ids(list_ids):
    ids0 = np_(list_ids)[0]
    return ids0[ids0 >= 0]


@pytest.fixture(scope="module")
def flat(data):
    j = jfl.build(data[0], jfl.IvfFlatParams(n_lists=N_LISTS, group_size=512,
                                             kmeans_n_iters=5))
    arrays = {k: np.asarray(getattr(j, k)) for k in
              ("centers", "list_data", "list_ids", "list_norms")}
    t = tfl.from_jax_arrays({"kind": "ivf_flat", "metric": j.metric,
                             "group_size": j.group_size}, arrays, device=CPU)
    return j, t, _masks(data[0].shape[0], _dead_list_ids(j.list_ids))


@pytest.fixture(scope="module")
def pq(data):
    j = jpq.build(data[0], jpq.IvfPqParams(n_lists=N_LISTS, pq_dim=16,
                                           group_size=512, kmeans_n_iters=5))
    arrays = {k: np.asarray(getattr(j, k)) for k in
              ("centers", "rotation", "codebooks", "list_codes", "list_ids",
               "b_sum")}
    t = tpq.from_jax_arrays(
        {"kind": "ivf_pq", "metric": j.metric, "pq_bits": j.pq_bits,
         "group_size": j.group_size, "codebook_kind": j.codebook_kind,
         "pq_dim_hint": j.pq_dim_hint}, arrays, device=CPU)
    return j, t, _masks(data[0].shape[0], _dead_list_ids(j.list_ids))


@pytest.fixture(scope="module")
def bq(data):
    j = jbq.build(data[0], jbq.IvfBqParams(n_lists=N_LISTS, kmeans_n_iters=5))
    arrays = {k: np.asarray(getattr(j, k)) for k in
              ("centers", "rotation", "list_codes", "list_ids", "list_scale",
               "list_bias")}
    t = tbq.from_jax_arrays({"kind": "ivf_bq", "metric": j.metric,
                             "bits": j.bits,
                             "rotation_kind": j.rotation_kind}, arrays,
                            device=CPU)
    return j, t, _masks(data[0].shape[0], _dead_list_ids(j.list_ids))


def _filters(mask):
    jb = JBitset.from_mask(mask)
    return jb, carry_bitset(jb)


def _check(qs, jax_out, port_out, mask, rtol, l2=True, gather=False):
    """Parity with the JAX result, the mask never violated, an all-fail
    filter all -1 / +inf."""
    jv, ji = (torch.from_numpy(np.array(x)) for x in jax_out)
    tv, ti = port_out
    atol = 0.0
    if l2 and not gather:
        atol = 5e-4 * float((qs.astype(np.float64) ** 2).sum(1).max())
    verdict = tmet.topk_agreement(jv, ji.to(torch.int32), tv,
                                  ti.to(torch.int32), rtol=rtol, atol=atol,
                                  tie_rtol=1e-3 if not gather else 1e-5)
    assert verdict["ok"], verdict
    got = np_(ti)
    assert mask[got[got >= 0]].all(), "a filtered-out id came back"
    if not mask.any():
        assert (got == -1).all() and np.isposinf(np_(tv)).all()


@pytest.mark.parametrize("mask_name", MASKS)
@pytest.mark.parametrize("backend", ["ragged", "gather"])
def test_ivf_flat_filtered_matches_jax(data, flat, backend, mask_name):
    _, qs = data
    j, t, masks = flat
    jf, tf = _filters(masks[mask_name])
    jout = jfl.search(j, qs, K, n_probes=N_PROBES, filter=jf, backend=backend)
    tout = tfl.search(t, qs, K, n_probes=N_PROBES, filter=tf,
                      backend=backend, device=CPU)
    _check(qs, jout, tout, masks[mask_name],
           1e-5 if backend == "gather" else 5e-4, gather=backend == "gather")


@pytest.mark.parametrize("mask_name", MASKS)
@pytest.mark.parametrize("backend", ["ragged", "pallas", "gather"])
def test_ivf_pq_filtered_matches_jax(data, pq, backend, mask_name):
    _, qs = data
    j, t, masks = pq
    jf, tf = _filters(masks[mask_name])
    jout = jpq.search(j, qs, K, n_probes=N_PROBES, filter=jf, backend=backend)
    tout = tpq.search(t, qs, K, n_probes=N_PROBES, filter=tf,
                      backend=backend, device=CPU)
    # ragged scans the bf16 cache; pallas sums bf16 LUT entries in fp32
    _check(qs, jout, tout, masks[mask_name],
           1e-5 if backend == "gather" else 5e-4, gather=backend != "ragged")


@pytest.mark.parametrize("mask_name", MASKS)
def test_ivf_bq_filtered_matches_jax(data, bq, mask_name):
    _, qs = data
    j, t, masks = bq
    jf, tf = _filters(masks[mask_name])
    jout = jbq.search(j, qs, K, n_probes=N_PROBES, filter=jf,
                      backend="reference")
    tout = tbq.search(t, qs, K, n_probes=N_PROBES, filter=tf, device=CPU)
    _check(qs, jout, tout, masks[mask_name], 5e-4)


@pytest.mark.parametrize("mask_name", ["random50", "all_fail", "list_dead"])
def test_ivf_bq_refined_filtered_matches_jax(data, bq, mask_name):
    ds, qs = data
    j, t, masks = bq
    jf, tf = _filters(masks[mask_name])
    jout = jbq.search_refined(j, ds, qs, K, n_probes=N_PROBES, filter=jf)
    tout = tbq.search_refined(t, ds, qs, K, n_probes=N_PROBES, filter=tf,
                              device=CPU)
    _check(qs, jout, tout, masks[mask_name], 1e-5, gather=True)


def test_search_refined_widens_k_fetch(data, bq, monkeypatch):
    ds, qs = data
    _, t, _ = bq
    mask = np.arange(ds.shape[0]) % 10 == 0              # 10% pass
    seen = []
    real = tbq.search

    def spy(index, queries, k, **kw):
        seen.append((k, kw["n_probes"]))
        return real(index, queries, k, **kw)

    monkeypatch.setattr(tbq, "search", spy)
    tbq.search_refined(t, ds, qs, K, n_probes=2, refine_ratio=4,
                       filter=Bitset.from_mask(mask, device=CPU), device=CPU)
    want = jfil.widen_plan(JBitset.from_mask(mask), 2, N_LISTS, k_fetch=40,
                           k_cap=512)[1]
    assert seen == [(want, 2)] and want == 320
    tbq.search_refined(t, ds, qs, 60, n_probes=2, refine_ratio=4,
                       filter=Bitset.from_mask(mask, device=CPU), device=CPU)
    assert seen[-1][0] == 512                              # k_cap


@pytest.mark.parametrize("family", ["flat", "pq", "bq"])
def test_post_filter_identity_at_all_lists(data, flat, pq, bq, family):
    """Probing every list at equal over-fetch, the filtered scan returns
    exactly the unfiltered scan with failing ids dropped (the port against
    itself: the bias rule adds no candidate and loses none)."""
    _, qs = data
    mod, (_, t, masks) = {"flat": (tfl, flat), "pq": (tpq, pq),
                          "bq": (tbq, bq)}[family]
    kw = {"backend": "ragged"} if family != "bq" else {}
    for name in ("random50", "list_dead", "all_fail"):
        mask = masks[name]
        kf = max(K, min(int(mask.sum()) + 1, 512))
        v, i = mod.search(t, qs, kf, n_probes=N_LISTS, device=CPU, **kw)
        fv, fi = mod.search(t, qs, K, n_probes=N_LISTS, device=CPU,
                            filter=Bitset.from_mask(mask, device=CPU), **kw)
        for r in range(qs.shape[0]):
            keep = [(vv, ii) for vv, ii in zip(v[r].tolist(), i[r].tolist())
                    if ii >= 0 and mask[ii]][:K]
            n = len(keep)
            assert fi[r, :n].tolist() == [ii for _, ii in keep], (name, r)
            np.testing.assert_allclose(fv[r, :n].numpy(),
                                       [vv for vv, _ in keep], rtol=1e-6)
            assert (fi[r, n:] == -1).all()


# ---------------------------------------------------------------------------
# Paged stores: per-call and standing filters
# ---------------------------------------------------------------------------

def _stores(j, t):
    return (jsv.PagedListStore.from_index(j, page_rows=64),
            tsv.PagedListStore.from_index(t, page_rows=64, device=CPU))


@pytest.mark.parametrize("mask_name", MASKS)
@pytest.mark.parametrize("kind", ["flat", "pq", "bq"])
def test_paged_filtered_matches_jax(data, flat, pq, bq, kind, mask_name):
    _, qs = data
    jmod, tmod, (j, t, masks) = {"flat": (jfl, tfl, flat),
                                 "pq": (jpq, tpq, pq),
                                 "bq": (jbq, tbq, bq)}[kind]
    jst, tst = _stores(j, t)
    jf, tf = _filters(masks[mask_name])
    jout = jmod.search_paged(jst, qs, K, n_probes=N_PROBES, filter=jf,
                             backend="paged_pallas")
    tout = tmod.search_paged(tst, qs, K, n_probes=N_PROBES, filter=tf,
                             device=CPU)
    _check(qs, jout, tout, masks[mask_name], 5e-4)
    if kind == "bq":
        return
    jout = jmod.search_paged(jst, qs, K, n_probes=N_PROBES, filter=jf,
                             backend="gather")
    tout = tmod.search_paged(tst, qs, K, n_probes=N_PROBES, filter=tf,
                             backend="gather", device=CPU)
    _check(qs, jout, tout, masks[mask_name], 1e-5, gather=True)


def test_paged_bq_paged_jnp_is_the_twin_by_name(data, bq):
    _, qs = data
    j, t, masks = bq
    jst, tst = _stores(j, t)
    jf, tf = _filters(masks["random50"])
    jout = jbq.search_paged(jst, qs, K, n_probes=N_PROBES, filter=jf,
                            backend="paged_jnp")
    tout = tbq.search_paged(tst, qs, K, n_probes=N_PROBES, filter=tf,
                            backend="paged_jnp", device=CPU)
    _check(qs, jout, tout, masks["random50"], 5e-4)
    with pytest.raises(ValueError, match="unknown backend"):
        tbq.search_paged(tst, qs, K, backend="gather", device=CPU)


def test_standing_filter_precedence_upserts_and_compaction(data, flat):
    ds, qs = data
    _, t, masks = flat
    st = tsv.PagedListStore.from_index(t, page_rows=64, device=CPU)
    mask = masks["random50"]
    v0 = st.mutation_version
    st.set_filter(mask)                                  # a boolean array
    assert isinstance(st.filter, Bitset) and st.mutation_version == v0 + 1
    want = tfl.search_paged(st, qs, K, n_probes=N_PROBES, device=CPU,
                            filter=Bitset.from_mask(mask, device=CPU))
    got = tfl.search_paged(st, qs, K, n_probes=N_PROBES, device=CPU)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert mask[np_(got[1])[np_(got[1]) >= 0]].all()
    # a per-call filter wins over the standing one
    other = ~mask
    got = tfl.search_paged(st, qs, K, n_probes=N_PROBES, device=CPU,
                           filter=Bitset.from_mask(other, device=CPU))
    assert other[np_(got[1])[np_(got[1]) >= 0]].all()
    # rows upserted after the mask was built are past its length: excluded
    st.upsert(qs, ids=np.arange(ds.shape[0], ds.shape[0] + qs.shape[0]))
    _, ids = tfl.search_paged(st, qs, 1, n_probes=N_PROBES, device=CPU)
    assert int((ids >= ds.shape[0]).sum()) == 0
    st.set_filter(None)
    _, ids = tfl.search_paged(st, qs, 1, n_probes=N_PROBES, device=CPU)
    assert (np_(ids)[:, 0] == np.arange(ds.shape[0],
                                        ds.shape[0] + qs.shape[0])).all()
    # the standing filter survives compact and compact_swap
    st.set_filter(mask)
    before = tfl.search_paged(st, qs, K, n_probes=N_PROBES, device=CPU)
    version = st.mutation_version
    assert st.compact_swap(st.compact(), version)
    assert st.filter is not None
    after = tfl.search_paged(st, qs, K, n_probes=N_PROBES, device=CPU)
    assert torch.equal(before[1], after[1])


def test_standing_filter_matches_jax_set_filter(data, pq):
    _, qs = data
    j, t, masks = pq
    jst, tst = _stores(j, t)
    jst.set_filter(masks["random50"])
    tst.set_filter(masks["random50"])
    jout = jpq.search_paged(jst, qs, K, n_probes=N_PROBES,
                            backend="paged_pallas")
    tout = tpq.search_paged(tst, qs, K, n_probes=N_PROBES, device=CPU)
    _check(qs, jout, tout, masks["random50"], 5e-4)


# ---------------------------------------------------------------------------
# CAGRA and brute force
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cagra_pair():
    """A compress="on" JAX index of 5,000 × 32 (past 4,096 rows, so both
    packages seed from its k-means table, not at random) and its port
    copy."""
    ds, qs = sift_like(5000, 32, 64, seed=12)
    ds, qs = ds.astype(np.float32), qs.astype(np.float32)
    j = jcg.build(ds, jcg.CagraParams(intermediate_graph_degree=32,
                                      graph_degree=16, compress="on"))
    arrays = {name: np.asarray(getattr(j, name)) for name in
              ("dataset", "graph", "norms", "proj", "code_scale", "nbr_codes",
               "centroids", "centroid_reps", "proj_energy")}
    t = tcg.from_jax_arrays({"kind": "cagra"}, arrays, device=CPU)
    dead = np.asarray(j.graph)[0]
    return qs, j, t, _masks(ds.shape[0], dead[dead >= 0])


@pytest.mark.parametrize("mask_name", MASKS)
@pytest.mark.parametrize("traversal", ["fused", "compressed", "exact"])
def test_cagra_filtered_matches_jax(cagra_pair, traversal, mask_name):
    """Filtered-out nodes route, and never come back. The fused and
    compressed traversals seed from the index's table, so their ids equal
    JAX's except at near-ties; the exact loop seeds at random (jax.random
    against torch.Generator), so it is held to the mask rules alone."""
    qs, j, t, masks = cagra_pair
    mask = masks[mask_name]
    jf, tf = _filters(mask)
    jv, ji = jcg.search(j, qs, K, jcg.CagraSearchParams(
        itopk_size=64, search_width=4, traversal=traversal), filter=jf)
    tv, ti = tcg.search(t, qs, K, tcg.CagraSearchParams(
        itopk_size=64, search_width=4, traversal=traversal), filter=tf,
        device=CPU)
    got = ti.numpy()
    assert mask[got[got >= 0]].all()
    if not mask.any():
        assert (got == -1).all() and np.isposinf(tv.numpy()).all()
    if traversal == "exact":
        return
    ji, jv = np.asarray(ji), np.asarray(jv)
    assert (ji != got).any(axis=1).mean() <= 0.02
    np.testing.assert_array_equal(np.isinf(tv.numpy()), np.isinf(jv))
    same = (ji == got).all(axis=1)
    np.testing.assert_allclose(tv.numpy()[same], jv[same], rtol=1e-4,
                               atol=1e-2)


@pytest.mark.parametrize("mask_name", MASKS)
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_brute_force_filtered_matches_jax(data, flat, metric, mask_name):
    ds, qs = data
    mask = flat[2][mask_name]
    jf, tf = _filters(mask)
    jout = jbf.search(jbf.build(ds, metric), qs, K, filter=jf)
    tout = tbf.search(tbf.build(ds, metric, device=CPU), qs, K, filter=tf,
                      tile_rows=700, device=CPU)
    if metric == "inner_product":
        jv, ji = (np.array(x) for x in jout)
        tv, ti = (x.numpy() for x in tout)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tv, jv, rtol=1e-5)
    else:
        _check(qs, jout, tout, mask, 1e-5, gather=True)
    with pytest.raises(ValueError, match="filter covers"):
        tbf.search(tbf.build(ds, device=CPU), qs, K,
                   filter=Bitset.from_mask(mask[:-1], device=CPU), device=CPU)
