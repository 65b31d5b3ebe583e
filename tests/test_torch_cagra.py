"""The CAGRA slice of the PyTorch port against the JAX package on the same
numpy inputs: the sort-based graph primitives and ``optimize`` bit for bit,
both branches of the traversal merge, searches of a JAX-built index carried
across (by arrays and by file), the port's own build by invariants and by
recall beside the JAX build, and what this slice leaves to later ones."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.bench.datasets import sift_like
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import cagra as jc
from raft_tpu.ops import linalg as jlinalg
from raft_tpu.ops import segment as jseg
from raft_tpu.stats import summary as jsummary
from raft_tpu_torch.comms import Comms, local_mesh
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.distributed import cagra as tdist
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tc
from raft_tpu_torch.neighbors import hnsw as thnsw
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.ops import linalg as tlinalg
from raft_tpu_torch.ops import segment as tseg
from raft_tpu_torch.ops import strip_scan as ss
from raft_tpu_torch.stats import summary as tsummary

torch.set_num_threads(2)
CPU = {"device": "cpu"}


def _recall(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.mean([len(set(g) & set(w)) / want.shape[1]
                          for g, w in zip(got, want)]))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def knn_graph():
    """An intermediate kNN graph (brute force, self dropped) of 3,000 rows."""
    data, _ = sift_like(3000, 16, 8, seed=1)
    X = data.astype(np.float32)
    _, nn = jbf.knn(X, X, 33)
    return np.asarray(jc._drop_self(nn, 0, 32))


@pytest.mark.parametrize("n_blocks", [1, 3])
def test_optimize_is_bitwise_the_jax_prune(knn_graph, n_blocks):
    want = np.asarray(jc.optimize(jnp.asarray(knn_graph), 16, n_blocks=2))
    got = tc.optimize(_t(knn_graph), 16, n_blocks=n_blocks).numpy()
    np.testing.assert_array_equal(got, want)


def test_optimize_on_a_graph_with_duplicates_and_holes():
    """Repeated ids, -1 edges and self edges in the rows: the detour counts
    are integers, so the sorted-key count equals the JAX compare loop."""
    rng = np.random.default_rng(2)
    n, k = 400, 12
    g = rng.integers(0, 60, (n, k)).astype(np.int32)
    g[rng.random((n, k)) < 0.15] = -1
    g[:5, 0] = np.arange(5)
    want = np.asarray(jc.optimize(jnp.asarray(g), 6))
    np.testing.assert_array_equal(tc.optimize(_t(g), 6).numpy(), want)


def test_drop_self_is_bitwise():
    rng = np.random.default_rng(3)
    ids = rng.integers(-1, 50, (40, 9)).astype(np.int32)
    ids[np.arange(40) % 3 == 0, 2] = (np.arange(40) + 7)[np.arange(40) % 3 == 0]
    want = np.asarray(jc._drop_self(jnp.asarray(ids), 7, 8))
    np.testing.assert_array_equal(tc._drop_self(_t(ids), 7, 8).numpy(), want)


def test_segment_take_is_bitwise():
    rng = np.random.default_rng(4)
    keys = np.sort(rng.integers(0, 25, 300)).astype(np.int32)
    keys[-20:] = 30                      # invalid entries sorted last
    vals = rng.integers(0, 1000, 300).astype(np.int32)
    want = jseg.segment_take(jnp.asarray(keys), 25, 7, jnp.asarray(vals))
    got = tseg.segment_take(_t(keys), 25, 7, _t(vals))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_merge_topk_dedup_is_bitwise():
    rng = np.random.default_rng(5)
    n, a, b = 30, 8, 12
    ids = rng.integers(-1, 40, (n, a)).astype(np.int32)
    cids = rng.integers(-1, 40, (n, b)).astype(np.int32)
    d = rng.integers(0, 20, (n, a)).astype(np.float32)     # ties on purpose
    cd = rng.integers(0, 20, (n, b)).astype(np.float32)
    d[ids < 0] = np.inf
    cd[cids < 0] = np.inf
    self_ids = np.arange(n, dtype=np.int32)
    want = jseg.merge_topk_dedup(
        jnp.asarray(ids), jnp.asarray(d), jnp.asarray(cids), jnp.asarray(cd),
        10, exclude_self=jnp.asarray(self_ids))
    got = tseg.merge_topk_dedup(_t(ids), _t(d), _t(cids), _t(cd), 10,
                                exclude_self=_t(self_ids))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("wide", [False, True])
def test_merge_candidates_is_bitwise(packed, wide):
    """Both dedup branches: exact below the limit, slack + re-select above."""
    rng = np.random.default_rng(7 + 2 * wide + packed)
    q, itopk, b = 12, 16, 48
    bids = rng.integers(-1, 80, (q, itopk)).astype(np.int32)
    bd = np.sort(rng.normal(size=(q, itopk)).astype(np.float32) * 9 + 30,
                 axis=1)
    bd[bids < 0] = np.inf
    bvis = rng.random((q, itopk)) < 0.5
    cids = rng.integers(-1, 80, (q, b)).astype(np.int32)
    cd = (rng.normal(size=(q, b)).astype(np.float32) * 9 + 30)
    limit = 32 if wide else 64
    want = jc._merge_candidates(*(jnp.asarray(x) for x in
                                  (bids, bd, bvis, cids, cd)), itopk,
                                packed=packed, dedup_limit=limit)
    got = tc._merge_candidates(*(_t(x) for x in (bids, bd, bvis, cids, cd)),
                               itopk, packed=packed, dedup_limit=limit)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cov_eig_dc_and_knn_match_the_jax_package():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(500, 12)).astype(np.float32) * np.arange(1, 13)
    c_j = np.asarray(jsummary.cov(jnp.asarray(x), sample=False))
    c_t = tsummary.cov(_t(x), sample=False).numpy()
    np.testing.assert_allclose(c_t, c_j, rtol=1e-5, atol=1e-4)
    w_j, v_j = jlinalg.eig_dc(jnp.asarray(c_j))
    w_t, v_t = tlinalg.eig_dc(_t(c_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-4)
    u = rng.normal(size=(6, 4)).astype(np.float32)
    np.testing.assert_array_equal(tlinalg.sign_flip(_t(u)).numpy(),
                                  np.asarray(jlinalg.sign_flip(jnp.asarray(u))))
    q = rng.normal(size=(20, 12)).astype(np.float32)
    _, i_j = jbf.knn(jnp.asarray(q), jnp.asarray(x), 5)
    _, i_t = tbf.knn(_t(q), _t(x), 5, **CPU)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))


# ---------------------------------------------------------------------------
# search on a JAX-built index carried across
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def carried():
    """A compress="on" JAX index of 10k × 32 (k-means seeding table, since
    n > 4096) and its port copy, queries and brute-force ground truth."""
    data, queries = sift_like(10_000, 32, 256, seed=3)
    X = data.astype(np.float32)
    Q = queries.astype(np.float32)
    jidx = jc.build(X, jc.CagraParams(graph_degree=32,
                                      intermediate_graph_degree=64,
                                      compress="on"))
    arrays = {name: np.asarray(getattr(jidx, name)) for name in
              ("dataset", "graph", "norms", "proj", "code_scale", "nbr_codes",
               "centroids", "centroid_reps", "proj_energy")}
    tidx = tc.from_jax_arrays({"kind": "cagra"}, arrays, **CPU)
    _, gt = jbf.knn(Q, X, 10)
    return jidx, tidx, Q, np.asarray(gt)


@pytest.mark.parametrize("traversal,itopk,width", [
    ("fused", 64, 4), ("fused", 32, 1), ("compressed", 64, 4),
    ("compressed", 64, 40), ("exact", 64, 4)])
def test_search_agrees_with_jax_on_a_carried_index(carried, traversal, itopk,
                                                   width):
    """Ids equal the JAX search's except where a seed or a near-tie differs
    (the exact loop seeds at random: ``jax.random`` against
    ``torch.Generator``), recall@10 within 0.005. (64, 40) runs the slack
    merge."""
    jidx, tidx, Q, gt = carried
    jv, ji = jc.search(jidx, Q, 10, jc.CagraSearchParams(
        itopk_size=itopk, search_width=width, traversal=traversal))
    st = {}
    tv, ti = tc.search(tidx, Q, 10, tc.CagraSearchParams(
        itopk_size=itopk, search_width=width, traversal=traversal), **CPU,
        stats=st)
    ji, ti = np.asarray(ji), ti.numpy()
    assert st["mode"] == ("compressed" if width == 40 else traversal)
    rows = (ji != ti).any(axis=1).mean()
    assert rows <= (0.05 if traversal == "exact" else 0.01), rows
    assert abs(_recall(ti, gt) - _recall(ji, gt)) <= 0.005
    same = (ji == ti).all(axis=1)
    np.testing.assert_allclose(tv.numpy()[same], np.asarray(jv)[same],
                               rtol=1e-4, atol=1e-2)


def test_fused_twin_equals_the_compressed_loop(carried):
    """The fused loop (the hop's twin on the CPU) and the unfused loop are
    one traversal: same ids, same distances."""
    _, tidx, Q, _ = carried
    out = [tc.search(tidx, Q[:100], 10, tc.CagraSearchParams(
        itopk_size=64, search_width=4, traversal=t), **CPU)
        for t in ("fused", "compressed")]
    assert torch.equal(out[0][1], out[1][1])
    assert torch.equal(out[0][0], out[1][0])


def test_cagra_files_cross_both_ways(carried, tmp_path):
    jidx, tidx, Q, _ = carried
    jpath, tpath = tmp_path / "jax.bin", tmp_path / "torch.bin"
    jidx.save(jpath)
    loaded = tc.CagraIndex.load(jpath, **CPU)
    for name, t in tidx.arrays().items():
        assert torch.equal(getattr(loaded, name), t), name
    sp = tc.CagraSearchParams(itopk_size=64, search_width=4)
    a = tc.search(loaded, Q[:64], 10, sp, **CPU)
    b = tc.search(tidx, Q[:64], 10, sp, **CPU)
    assert torch.equal(a[1], b[1])
    loaded.save(tpath)
    back = jc.CagraIndex.load(tpath)
    for name in ("dataset", "graph", "norms", "proj", "code_scale",
                 "nbr_codes", "centroids", "centroid_reps", "proj_energy"):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(getattr(jidx, name)))
    assert tc.CagraIndex.load(tpath, **CPU).to("cpu").nbr_codes.dtype \
        == torch.int8


def _resolve(sp, has_payload=True, k=5, itopk=64, size=1000, width=1,
             degree=64, proj_dim=64, on_cuda=False):
    return tc._resolve_traversal(sp, has_payload, k, itopk, size=size,
                                 width=width, degree=degree,
                                 proj_dim=proj_dim, on_cuda=on_cuda)


def test_resolve_traversal_modes():
    sp = tc.CagraSearchParams()
    assert _resolve(sp)[0] == "compressed"
    assert _resolve(sp, on_cuda=True)[0] == "fused"
    assert _resolve(sp, has_payload=False)[0] == "exact"
    assert _resolve(sp, has_payload=False, on_cuda=True)[0] == "exact"
    sp_f = tc.CagraSearchParams(traversal="fused")
    assert _resolve(sp_f) == ("fused", 64)
    assert _resolve(sp_f, size=(1 << 24) + 1)[0] == "fused"  # past the TPU's
    # off the card, past the JAX package's fused gate: the loop it matches
    wide = tc._CAGRA_DEDUP_LIMIT // 64 + 1
    assert _resolve(sp_f, width=wide)[0] == "compressed"
    assert _resolve(sp_f, width=wide, itopk=2048)[0] == "compressed"
    with pytest.raises(ValueError, match="compression payload"):
        _resolve(sp_f, has_payload=False)
    with pytest.raises(ValueError, match="refine_topk"):
        _resolve(tc.CagraSearchParams(refine_topk=5), k=10)


@pytest.mark.parametrize("sp", [tc.CagraSearchParams(),
                                tc.CagraSearchParams(traversal="fused")],
                         ids=["auto", "fused"])
def test_resolve_traversal_on_a_card_runs_k6_or_raises(sp):
    """On a card "fused" (asked for, or taken by "auto") is K6 at every
    shape K6 takes, past the JAX package's width·degree gate too, and
    raises where K6 cannot run; it never turns into another loop."""
    wide = tc._CAGRA_DEDUP_LIMIT // 64 + 1
    assert _resolve(sp, width=wide, on_cuda=True) == ("fused", 64)
    assert _resolve(sp, width=16, itopk=64, on_cuda=True)[0] == "fused"
    for shape in (dict(width=32),                   # merge past 2048
                  dict(size=1 << 31),               # ids past int32
                  dict(width=15, degree=128, proj_dim=128)):  # shared memory
        with pytest.raises(ValueError, match="K6"):
            _resolve(sp, on_cuda=True, **shape)


# ---------------------------------------------------------------------------
# the port's own build
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def build_data():
    data, queries = sift_like(6000, 32, 200, seed=5)
    X = data.astype(np.float32)
    _, gt = jbf.knn(queries.astype(np.float32), X, 10)
    return data, queries.astype(np.float32), np.asarray(gt)


@pytest.mark.parametrize("algo", ["brute", "ivf_pq"])
def test_port_build_invariants_and_recall_beside_jax(build_data, algo):
    """The port's build (its own random streams) by invariants, and its
    compressed search by recall within 0.02 of the JAX build's. "ivf_pq"
    at this size is the IVF-Flat candidate scan."""
    data, Q, gt = build_data
    params = dict(intermediate_graph_degree=32, graph_degree=16,
                  build_algo=algo, compress="on", compress_dim=16)
    idx = tc.build(data, tc.CagraParams(**params), **CPU)
    n, p = data.shape[0], 16
    g = idx.graph
    assert idx.dataset.dtype == torch.uint8
    assert g.shape == (n, 16) and bool((g >= 0).all())
    assert not bool((g == torch.arange(n)[:, None]).any())
    assert all(len(set(row)) == 16 for row in g[::97].tolist())
    assert set(idx.build_timings_s) == {"knn_graph", "optimize", "compress"}
    proj = idx.proj
    assert torch.allclose(proj.T @ proj, torch.eye(p), atol=1e-5)
    assert 0.0 < float(idx.proj_energy) <= 1.0
    codes = torch.clamp(torch.round(
        (idx.dataset.float() @ proj) / idx.code_scale), -127, 127)
    assert float(codes.abs().max()) == 127.0
    assert torch.equal(idx.nbr_codes[:50].float(), codes[g[:50].long()])
    assert idx.centroids is not None and idx.centroid_reps.dtype == torch.int32
    sp = dict(itopk_size=64, search_width=4, traversal="compressed")
    jidx = jc.build(data, jc.CagraParams(**params))
    _, ji = jc.search(jidx, Q, 10, jc.CagraSearchParams(**sp))
    _, ti = tc.search(idx, Q, 10, tc.CagraSearchParams(**sp), **CPU)
    assert _recall(ti.numpy(), gt) >= _recall(ji, gt) - 0.02


def test_compress_off_searches_exactly(build_data):
    data, Q, gt = build_data
    idx = tc.build(data[:3000], tc.CagraParams(
        intermediate_graph_degree=32, graph_degree=16, compress="off"), **CPU)
    assert idx.nbr_codes is None and set(idx.arrays()) == {
        "dataset", "graph", "norms"}
    st = {}
    _, ids = tc.search(idx, Q[:32], 5, tc.CagraSearchParams(itopk_size=32),
                       **CPU, stats=st)
    assert st["mode"] == "exact" and ids.shape == (32, 5)
    with pytest.raises(ValueError, match="compression payload"):
        tc.search(idx, Q[:4], 5, tc.CagraSearchParams(traversal="fused"),
                  **CPU)
    v, i = tc.search(idx, Q[:0], 5, **CPU)
    assert v.shape == (0, 5) and i.shape == (0, 5)


def test_refine_knn_graph_keeps_exact_and_improves_random():
    rng = np.random.default_rng(0)
    n, ideg = 1200, 12
    X = torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32))
    _, nn = tbf.knn(X, X, ideg + 1, **CPU)
    exact = tc._drop_self(nn, 0, ideg)
    res = Resources(device="cpu")
    out = tc.refine_knn_graph(X, exact, 1, 64, 0, res)
    assert float((out >= 0).sum(1).float().mean()) == ideg
    assert _recall(out.numpy(), exact.numpy()) > 0.95
    bad = torch.from_numpy(rng.integers(0, n, (n, ideg)).astype(np.int32))
    after = tc.refine_knn_graph(X, bad, 3, 64, 0, res)
    assert _recall(after.numpy(), exact.numpy()) > \
        _recall(bad.numpy(), exact.numpy()) + 0.1


def test_candidate_scan_runs_k1_at_ideg_plus_one_every_batch(monkeypatch):
    """The IVF-Flat candidate scan asks the port's ivf_flat.search for
    kf = ideg + 1 = 129 at every batch, and every class call of every batch
    takes K1's function at that kf (the twin here; K1 on a card)."""
    data, _ = sift_like(5000, 16, 4, seed=6)
    X = torch.from_numpy(data.astype(np.float32))
    seen, batches = [], []
    strip_class, search = ss.strip_class, tflat.search

    def spy_class(*args, **kw):
        seen.append((len(batches), args[7] if len(args) > 7 else kw["kf"]))
        return strip_class(*args, **kw)

    def spy_search(index, queries, k, **kw):
        batches.append(k)
        return search(index, queries, k, **kw)

    monkeypatch.setattr(ss, "strip_class", spy_class)
    monkeypatch.setattr(tflat, "search", spy_search)
    res = Resources(device="cpu", workspace_bytes=1 << 20)
    graph, centers = tc._build_knn_ivf_pq(
        X, 128, tc.CagraParams(intermediate_graph_degree=128), res)
    assert batches == [129, 129]                 # 5000 rows, batches of 4096
    assert {b for b, _ in seen} == {1, 2}
    assert {kf for _, kf in seen} == {129}
    assert graph.shape == (5000, 128) and centers.shape == (16, 16)
    assert not bool((graph == torch.arange(5000)[:, None]).any())


def test_what_later_slices_bring_raises(build_data, carried, tmp_path):
    """Once the entries later slices were to bring; since the CAGRA
    remainder slice they serve: ``build_algo="nn_descent"`` builds, the
    hnsw export writes, the sharded index searches. What still raises is
    what is wrong: a filter of the wrong length, an unknown traversal, an
    index on another device."""
    data, Q, _ = build_data
    _, tidx, _, _ = carried
    idx = tc.build(data[:2100], tc.CagraParams(
        intermediate_graph_degree=16, graph_degree=8, build_algo="nn_descent",
        nn_descent_niter=3), **CPU)
    assert idx.graph.shape == (2100, 8)
    assert not bool((idx.graph == torch.arange(2100)[:, None]).any())
    with pytest.raises(ValueError, match="filter covers"):
        tc.search(tidx, Q[:4, :32], 5,
                  filter=Bitset.from_mask(np.ones(10, bool), **CPU), **CPU)
    assert thnsw.save_to_hnswlib(idx, tmp_path / "g.bin") in ("native",
                                                              "python")
    assert thnsw.HnswIndex.load(tmp_path / "g.bin", dim=32).graph.shape == (
        2100, 8)
    sharded = tdist.build(data[:2500], tc.CagraParams(
        intermediate_graph_degree=16, graph_degree=8),
        comms=Comms(local_mesh(2, device="cpu")), **CPU)
    _, ids = tdist.search(sharded, Q[:4], 5, **CPU)
    assert ids.shape == (4, 5) and bool((ids < 2500).all())
    with pytest.raises(ValueError, match="unknown traversal"):
        tc.CagraSearchParams(traversal="pallas")
    with pytest.raises(ValueError, match="index lives on"):
        tc.search(tidx, Q[:4, :32], 5, device="meta")
