"""Port parity: the IVF-PQ main path of raft_tpu_torch against raft_tpu on
the same numpy data — search on a JAX-built index carried across, search +
refine recall, brute force, refine, recall, k-means and a port-built index.

The JAX reference runs ``ivf_pq.search(..., backend="ragged")``, which runs
the strip kernel in Pallas interpret mode on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.cluster import kmeans_balanced as jkm
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import refine as jref
from raft_tpu.stats import metrics as jmet
from raft_tpu_torch.bench.datasets import sift_like
from raft_tpu_torch.cluster import kmeans_balanced as tkm
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import refine as trf
from raft_tpu_torch.stats import metrics as tmet

torch.set_num_threads(2)

PARAMS = dict(n_lists=32, pq_dim=16, group_size=512,
              kmeans_trainset_fraction=0.5)
CPU = "cpu"


@pytest.fixture(scope="module")
def data():
    ds, qs = sift_like(20_000, 32, 300, seed=3)
    return ds.astype(np.float32), qs.astype(np.float32)


@pytest.fixture(scope="module")
def gt(data):
    ds, qs = data
    v, i = jbf.search(jbf.build(ds), qs, 10)
    return np.array(v), np.array(i)


@pytest.fixture(scope="module")
def jax_index(data):
    return jpq.build(data[0], jpq.IvfPqParams(**PARAMS))


def _carried(jidx):
    meta = {"kind": "ivf_pq", "metric": jidx.metric, "pq_bits": jidx.pq_bits,
            "group_size": jidx.group_size, "codebook_kind": jidx.codebook_kind,
            "pq_dim_hint": jidx.pq_dim_hint}
    arrays = {k: np.asarray(getattr(jidx, k)) for k in
              ("centers", "rotation", "codebooks", "list_codes", "list_ids",
               "b_sum")}
    return tpq.from_jax_arrays(meta, arrays, device=CPU)


def _recall_jax(idx, data, gt, kf, p):
    ds, qs = data
    _, cand = jpq.search(idx, qs, kf, n_probes=p, backend="ragged")
    v, i = jref.refine(ds, qs, cand, 10)
    return float(jmet.neighborhood_recall(i, gt[1], v, gt[0]))


def _recall_port(idx, data, gt, kf, p):
    ds, qs = data
    _, cand = tpq.search(idx, qs, kf, n_probes=p, backend="ragged",
                         device=CPU)
    v, i = trf.refine(ds, qs, cand, 10, device=CPU)
    return tmet.neighborhood_recall(i, torch.from_numpy(gt[1]), v,
                                    torch.from_numpy(gt[0]))


@pytest.mark.parametrize("kf,n_probes", [(40, 4), (20, 4), (10, 8)])
def test_search_on_jax_index_matches(data, jax_index, kf, n_probes):
    _, qs = data
    jv, ji = jpq.search(jax_index, qs, kf, n_probes=n_probes, backend="ragged")
    tv, ti = tpq.search(_carried(jax_index), qs, kf, n_probes=n_probes,
                        backend="ragged", device=CPU)
    # the scan ranks scores of magnitude ‖q‖² (5e-4 relative, one packing
    # quantum); adding ‖q‖² back cancels most of it, so the same error is
    # absolute on the returned distances
    atol = 5e-4 * float((qs.astype(np.float64) ** 2).sum(1).max())
    verdict = tmet.topk_agreement(torch.from_numpy(np.array(jv)),
                                  torch.from_numpy(np.array(ji)), tv, ti,
                                  rtol=5e-4, atol=atol, tie_rtol=1e-3)
    assert verdict["ok"], verdict


@pytest.mark.parametrize("kf,n_probes", [(40, 4), (10, 8)])
def test_refined_recall_on_jax_index_within_0_005(data, gt, jax_index, kf,
                                                   n_probes):
    want = _recall_jax(jax_index, data, gt, kf, n_probes)
    got = _recall_port(_carried(jax_index), data, gt, kf, n_probes)
    assert abs(got - want) <= 0.005, (got, want)


def test_index_files_cross_both_ways(tmp_path, data, jax_index):
    _, qs = data
    jax_index.save(tmp_path / "jax.idx")
    port = tpq.IvfPqIndex.load(tmp_path / "jax.idx", device=CPU)
    for name, t in port.arrays().items():
        assert t.numpy().tobytes() == np.asarray(
            getattr(jax_index, name)).tobytes(), name
    port.save(tmp_path / "port.idx")
    back = jpq.IvfPqIndex.load(tmp_path / "port.idx")
    _, i1 = jpq.search(jax_index, qs[:50], 10, n_probes=4, backend="ragged")
    _, i2 = jpq.search(back, qs[:50], 10, n_probes=4, backend="ragged")
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_brute_force_matches(data, gt):
    ds, qs = data
    tv, ti = tbf.search(tbf.build(ds, device=CPU), qs, 10, tile_rows=3000,
                        device=CPU)
    np.testing.assert_array_equal(ti.numpy(), gt[1])
    np.testing.assert_allclose(tv.numpy(), gt[0], rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_refine_matches(data, metric):
    ds, qs = data
    rng = np.random.default_rng(8)
    cand = rng.integers(0, ds.shape[0], (qs.shape[0], 30)).astype(np.int32)
    cand[:, -3:] = -1
    jv, ji = jref.refine(ds, qs, cand, 10, metric=metric)
    tv, ti = trf.refine(ds, qs, cand, 10, metric=metric, device=CPU)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-2)


def test_neighborhood_recall_matches():
    rng = np.random.default_rng(2)
    ref = rng.integers(0, 50, (40, 10)).astype(np.int32)
    got = np.where(rng.random((40, 10)) < 0.7, ref,
                   rng.integers(0, 50, (40, 10))).astype(np.int32)
    rd = np.sort(rng.random((40, 10)).astype(np.float32), 1)
    d = (rd * (1 + rng.choice([0, 5e-4, 1e-2], (40, 10)))).astype(np.float32)
    assert tmet.neighborhood_recall(got, ref) == pytest.approx(
        float(jmet.neighborhood_recall(got, ref)), abs=1e-6)
    assert tmet.neighborhood_recall(got, ref, d, rd) == pytest.approx(
        float(jmet.neighborhood_recall(jnp.asarray(got), jnp.asarray(ref),
                                       jnp.asarray(d), jnp.asarray(rd))),
        abs=1e-6)


def test_kmeans_balance_and_inertia_within_5pct():
    """Same data, same parameters. Isotropic data: on skewed mixtures the
    largest-cluster share moves by more than 5% between two seeds of one
    package, so the comparison would measure the seed, not the port."""
    x = np.random.default_rng(0).standard_normal((8000, 16)).astype(np.float32)

    def stats(c, lab):
        c, lab = np.asarray(c), np.asarray(lab)
        sizes = np.bincount(lab, minlength=32)
        return float(((x - c[lab]) ** 2).sum()), sizes.max() / sizes.mean(), \
            sizes.min()

    p = dict(n_iters=20, seed=0)
    ji, jb, _ = stats(*jkm.fit_predict(x, 32, jkm.KMeansBalancedParams(**p)))
    ti, tb, tmin = stats(*tkm.fit_predict(x, 32, tkm.KMeansBalancedParams(**p),
                                          device=CPU))
    assert abs(ti / ji - 1) <= 0.05, (ti, ji)
    assert abs(tb / jb - 1) <= 0.05, (tb, jb)
    assert tmin >= 0.25 * 8000 / 32          # no cluster left underweight


@pytest.fixture(scope="module")
def port_index(data):
    return tpq.build(data[0], tpq.IvfPqParams(**PARAMS), device=CPU)


def test_port_built_index_invariants(port_index, data):
    R = port_index.rotation
    assert (R @ R.T - torch.eye(R.shape[0])).abs().max() <= 1e-5
    assert port_index.size == data[0].shape[0]
    assert port_index.max_list_size % 512 == 0
    ids = port_index.list_ids[port_index.list_ids >= 0]
    assert torch.equal(ids.sort().values, torch.arange(data[0].shape[0],
                                                       dtype=torch.int32))
    assert torch.isinf(port_index.b_sum[port_index.list_ids < 0]).all()
    assert torch.isfinite(port_index.b_sum[port_index.list_ids >= 0]).all()


@pytest.mark.parametrize("kf,n_probes", [(40, 4), (10, 8)])
def test_port_built_recall_within_0_02(port_index, jax_index, data, gt, kf,
                                       n_probes):
    want = _recall_jax(jax_index, data, gt, kf, n_probes)
    got = _recall_port(port_index, data, gt, kf, n_probes)
    assert abs(got - want) <= 0.02, (got, want)


def test_decode_cache_and_b_sum_match_jax(jax_index):
    port = _carried(jax_index)
    cache, scale = tpq._decode_lists(port.codebooks, port.list_codes,
                                     port.pq_dim, port.pq_bits)
    jcache, jscale = jpq._decode_lists(jax_index.codebooks,
                                       jax_index.list_codes,
                                       pq_dim=jax_index.pq_dim, pq_bits=8)
    assert float(scale) == float(jscale)
    np.testing.assert_array_equal(cache.numpy(), np.asarray(jcache))
    b_sum = tpq._compute_b_sum(port.centers, port.rotation, port.codebooks,
                               port.list_codes, port.list_ids, "sqeuclidean",
                               port.pq_dim)
    np.testing.assert_allclose(b_sum.numpy(), np.asarray(jax_index.b_sum),
                               rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("bits", [4, 5, 8])
def test_pack_codes_matches_jax(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 1 << bits, (7, 13)).astype(np.uint8)
    want = np.asarray(jpq.pack_codes(jnp.asarray(codes), bits))
    got = tpq.pack_codes(torch.from_numpy(codes), bits)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tpq.unpack_codes(got, 13, bits).numpy(), codes)


def test_later_slice_features_raise(port_index, data):
    """Filtered search, once a later slice's, now serves: an all-fail
    filter returns ids -1 and values +inf on every backend."""
    _, qs = data
    none = Bitset.create(port_index.size, False, device=CPU)
    for backend in ("ragged", "pallas", "gather"):
        v, i = tpq.search(port_index, qs, 10, filter=none, backend=backend,
                          device=CPU)
        assert (i == -1).all() and torch.isinf(v).all() and (v > 0).all()
