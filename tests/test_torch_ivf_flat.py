"""Port parity: raft_tpu_torch.neighbors.ivf_flat against raft_tpu on the
same numpy data — packed search on a JAX-built index carried across (for
all four metrics, and through the v2 file both ways), recall, a
port-built index, and the gather backend with the ``"auto"`` rule.

The strip-path tests run both packages with ``backend="ragged"`` (JAX: the
strip kernel in Pallas interpret mode on the CPU; the port: K1's twin),
because ``"auto"`` is the gather backend on the CPU in both. The data is
uint8 (``sift_like``), stored as uint8 lists by both builds, so K1's twin
scans uint8 rows; uint8 distances are exact in bf16 × bf16 → fp32.

The gather backend is held to JAX's default search (its gather backend on
the CPU) on float data at the 64-row granule (max_list_size 256, which
the strip plan cannot take): values at rtol 1e-5, ids equal except at
near-ties (1e-5 relative), since both sum the same fp32 products.

Tolerances: values allclose at rtol 5e-4 (plus, for the L2 metrics, an
absolute 5e-4·max‖q‖²: the scan ranks scores of that magnitude and adding
‖q‖² back makes the same error absolute); ids equal except at near-ties
(1e-3 relative); recall within 0.005 on a carried-across index, 0.02 on a
port-built one.
"""

import numpy as np
import pytest
import torch

from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.stats import metrics as jmet
from raft_tpu_torch.bench.datasets import sift_like
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.stats import metrics as tmet

torch.set_num_threads(2)

METRICS = ("sqeuclidean", "euclidean", "inner_product", "cosine")
PARAMS = dict(n_lists=16, group_size=512, kmeans_n_iters=5,
              kmeans_trainset_fraction=0.5)
CPU = "cpu"


@pytest.fixture(scope="module")
def data():
    return sift_like(5000, 24, 200, seed=4)


@pytest.fixture(scope="module")
def jax_indexes(data):
    return {m: jfl.build(data[0], jfl.IvfFlatParams(metric=m, **PARAMS))
            for m in METRICS}


def jax_arrays(jidx):
    meta = {"kind": "ivf_flat", "metric": jidx.metric,
            "group_size": jidx.group_size}
    arrays = {k: np.asarray(getattr(jidx, k)) for k in
              ("centers", "list_data", "list_ids")}
    if jidx.list_norms is not None:
        arrays["list_norms"] = np.asarray(jidx.list_norms)
    return meta, arrays


def carried(jidx):
    return tfl.from_jax_arrays(*jax_arrays(jidx), device=CPU)


def agree(qs, metric, jax_out, port_out):
    atol = 0.0
    if metric in ("sqeuclidean", "euclidean"):
        atol = 5e-4 * float((qs.astype(np.float64) ** 2).sum(1).max())
        if metric == "euclidean":
            atol = float(np.sqrt(atol))
    jv, ji = (torch.from_numpy(np.array(x)) for x in jax_out)
    verdict = tmet.topk_agreement(jv, ji, *port_out, rtol=5e-4, atol=atol,
                                  tie_rtol=1e-3)
    assert verdict["ok"], verdict


@pytest.mark.parametrize("metric", METRICS)
def test_search_on_jax_index_matches(data, jax_indexes, metric):
    _, qs = data
    jidx = jax_indexes[metric]
    port = carried(jidx)
    assert port.list_data.dtype == (torch.float32 if metric == "cosine"
                                    else torch.uint8)
    for k, n_probes in ((10, 4), (20, 2)):
        jout = jfl.search(jidx, qs, k, n_probes=n_probes, backend="ragged")
        tout = tfl.search(port, qs, k, n_probes=n_probes, backend="ragged",
                          device=CPU)
        agree(qs, metric, jout, tout)


@pytest.fixture(scope="module")
def gt(data):
    ds, qs = data
    v, i = jbf.search(jbf.build(ds.astype(np.float32)),
                      qs.astype(np.float32), 10)
    return np.array(v), np.array(i)


def _recall(vals_ids, gt):
    v, i = (torch.as_tensor(np.array(x)) for x in vals_ids)
    return tmet.neighborhood_recall(i, torch.from_numpy(gt[1]), v,
                                    torch.from_numpy(gt[0]))


@pytest.mark.parametrize("n_probes", [2, 6])
def test_recall_on_jax_index_within_0_005(data, gt, jax_indexes, n_probes):
    _, qs = data
    jidx = jax_indexes["sqeuclidean"]
    want = _recall(jfl.search(jidx, qs, 10, n_probes=n_probes,
                              backend="ragged"), gt)
    got = _recall(tfl.search(carried(jidx), qs, 10, n_probes=n_probes,
                             backend="ragged", device=CPU), gt)
    assert abs(got - want) <= 0.005, (got, want)
    assert float(jmet.neighborhood_recall(
        np.array(tfl.search(carried(jidx), qs, 10, n_probes=16,
                            backend="ragged", device=CPU)[1]), gt[1])) >= 0.99


def test_index_files_cross_both_ways(tmp_path, data, jax_indexes):
    _, qs = data
    jidx = jax_indexes["sqeuclidean"]
    jidx.save(tmp_path / "jax.idx")
    port = tfl.IvfFlatIndex.load(tmp_path / "jax.idx", device=CPU)
    for name, t in port.arrays().items():
        assert t.numpy().tobytes() == np.asarray(
            getattr(jidx, name)).tobytes(), name
    assert port.meta() == {"kind": "ivf_flat", "metric": "sqeuclidean",
                           "group_size": 512}
    port.save(tmp_path / "port.idx")
    back = jfl.IvfFlatIndex.load(tmp_path / "port.idx")
    _, i1 = jfl.search(jidx, qs[:40], 10, n_probes=4, backend="ragged")
    _, i2 = jfl.search(back, qs[:40], 10, n_probes=4, backend="ragged")
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    ip = jax_indexes["inner_product"]
    ip.save(tmp_path / "ip.idx")
    assert tfl.IvfFlatIndex.load(tmp_path / "ip.idx",
                                 device=CPU).list_norms is None


@pytest.fixture(scope="module")
def port_index(data):
    return tfl.build(data[0], tfl.IvfFlatParams(**PARAMS), device=CPU)


def test_port_built_index_invariants(port_index, data):
    ds = data[0]
    assert port_index.list_data.dtype == torch.uint8
    assert port_index.size == ds.shape[0]
    assert port_index.max_list_size % 512 == 0
    ids = port_index.list_ids[port_index.list_ids >= 0]
    assert torch.equal(ids.sort().values,
                       torch.arange(ds.shape[0], dtype=torch.int32))
    valid = port_index.list_ids >= 0
    want = port_index.list_data.float().pow(2).sum(-1)
    assert torch.equal(port_index.list_norms[valid], want[valid])
    rows = port_index.list_data[valid].numpy()
    np.testing.assert_array_equal(rows, ds[port_index.list_ids[valid].numpy()])


@pytest.mark.parametrize("n_probes", [2, 6])
def test_port_built_recall_within_0_02(port_index, jax_indexes, data, gt,
                                       n_probes):
    _, qs = data
    want = _recall(jfl.search(jax_indexes["sqeuclidean"], qs, 10,
                              n_probes=n_probes, backend="ragged"), gt)
    got = _recall(tfl.search(port_index, qs, 10, n_probes=n_probes,
                             backend="ragged", device=CPU), gt)
    assert abs(got - want) <= 0.02, (got, want)


def test_cosine_build_stores_normalized_rows(data):
    idx = tfl.build(data[0], tfl.IvfFlatParams(metric="cosine", **PARAMS),
                    device=CPU)
    valid = idx.list_ids >= 0
    norms = torch.linalg.vector_norm(idx.list_data[valid], dim=1)
    assert idx.list_data.dtype == torch.float32 and idx.list_norms is None
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)


def test_split_list_rows_matches_jax():
    rows = np.random.default_rng(6).standard_normal((300, 12)).astype(
        np.float32)
    for a, b in zip(tfl.split_list_rows(rows), jfl.split_list_rows(rows)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_later_slice_features_raise(port_index, data):
    """Filters and ``extend``, once a later slice's, now serve; an unknown
    backend still raises."""
    _, qs = data
    v, i = tfl.search(port_index, qs, 10, device=CPU,
                      filter=Bitset.create(port_index.size, False,
                                           device=CPU))
    assert (i == -1).all() and torch.isinf(v).all()
    grown = tfl.extend(port_index, qs, device=CPU)
    assert grown.size == port_index.size + qs.shape[0]
    with pytest.raises(ValueError, match="dim mismatch|must be"):
        tfl.extend(port_index, qs[:, :8], device=CPU)
    with pytest.raises(ValueError, match="unknown backend"):
        tfl.search(port_index, qs, 10, backend="paged", device=CPU)


# ---------------------------------------------------------------------------
# The gather backend and the "auto" rule
# ---------------------------------------------------------------------------

GATHER_PARAMS = dict(n_lists=64)     # both packages' default build otherwise


@pytest.fixture(scope="module")
def gather_data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((10000, 32)).astype(np.float32),
            rng.standard_normal((50, 32)).astype(np.float32))


@pytest.fixture(scope="module")
def gather_indexes(gather_data):
    return {m: jfl.build(gather_data[0],
                         jfl.IvfFlatParams(metric=m, **GATHER_PARAMS))
            for m in METRICS}


def agree_exact(jax_out, port_out):
    jv, ji = (torch.from_numpy(np.array(x)) for x in jax_out)
    tv, ti = port_out
    if ji.shape[1] and bool((jv[:, 0] > jv[:, -1]).any()):   # descending (ip)
        jv, tv = -jv, -tv
    verdict = tmet.topk_agreement(jv, ji, tv, ti, rtol=1e-5, atol=1e-5,
                                  tie_rtol=1e-5)
    assert verdict["ok"], verdict


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [10, 600])
def test_gather_default_search_matches_jax(gather_data, gather_indexes,
                                           metric, k):
    """Both packages' default search on the 64-row granule index: JAX takes
    its gather backend on the CPU, the port its own; k = 600 is past the
    strip plan's 512."""
    _, qs = gather_data
    jidx = gather_indexes[metric]
    assert jidx.max_list_size < 512     # 256 for L2: the strip plan's granule is 512
    port = carried(jidx)
    jout = jfl.search(jidx, qs, k, n_probes=8)
    tout = tfl.search(port, qs, k, n_probes=8, device=CPU)
    assert tout[0].shape == (50, k) and tout[1].dtype == torch.int32
    agree_exact(jout, tout)
    explicit = tfl.search(port, qs, k, n_probes=8, backend="gather",
                          device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(tout, explicit))


def test_gather_tiles_and_short_lists(gather_data, gather_indexes):
    """A workspace of a few tiles gives the same answer as one tile, and
    probes whose lists hold fewer than k rows return -1 ids at ±inf."""
    _, qs = gather_data
    port = carried(gather_indexes["sqeuclidean"])
    whole = tfl.search(port, qs, 10, n_probes=8, device=CPU)
    tiny = tfl.Resources(device=CPU, workspace_bytes=8 * 256 * 34 * 4 * 7)
    tiled = tfl.search(port, qs, 10, n_probes=8, res=tiny)
    assert all(torch.equal(a, b) for a, b in zip(whole, tiled))
    v, i = tfl.search(port, qs, 2000, n_probes=8, device=CPU)
    jv, ji = jfl.search(gather_indexes["sqeuclidean"], qs, 2000, n_probes=8)
    np.testing.assert_array_equal(i.numpy() == -1, np.asarray(ji) == -1)
    assert bool((i == -1).any()) and bool(torch.isinf(v[i == -1]).all())


def test_port_default_build_serves_the_default_search(gather_data,
                                                      gather_indexes):
    """The port's default build picks the 64-row granule as JAX does, and
    its default search serves it (it raised before the gather backend)."""
    ds, qs = gather_data
    port = tfl.build(ds, tfl.IvfFlatParams(**GATHER_PARAMS), device=CPU)
    assert port.max_list_size == gather_indexes["sqeuclidean"].max_list_size
    v, i = tfl.search(port, qs, 10, n_probes=8, device=CPU)
    gv, gi = jbf.search(jbf.build(ds), qs, 10)
    want = float(jmet.neighborhood_recall(
        np.asarray(jfl.search(gather_indexes["sqeuclidean"], qs, 10,
                              n_probes=8)[1]), np.asarray(gi)))
    got = float(jmet.neighborhood_recall(i.numpy(), np.asarray(gi)))
    assert abs(got - want) <= 0.02, (got, want)


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
@pytest.mark.parametrize("mls", [64, 256, 512, 1024, 1536, 2048])
@pytest.mark.parametrize("k", [1, 512, 513])
def test_auto_backend_rule(device_type, mls, k):
    got = tfl.resolve_backend("auto", device_type, mls, k)
    strip = mls % 512 == 0 and (mls // 512) & (mls // 512 - 1) == 0
    want = "ragged" if device_type == "cuda" and strip and k <= 512 \
        else "gather"
    assert got == want
    assert tfl.resolve_backend("gather", device_type, mls, k) == "gather"
    if strip and k <= 512:
        assert tfl.resolve_backend("ragged", device_type, mls, k) == "ragged"
    else:
        with pytest.raises(ValueError, match="ragged backend needs"):
            tfl.resolve_backend("ragged", device_type, mls, k)
