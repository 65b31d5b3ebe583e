"""Port parity: the IVF-BQ path of raft_tpu_torch against raft_tpu on the
same numpy data — the encoder, search on a JAX-built index carried across,
refined recall, a port-built index, and the index files.

The JAX reference searches with ``ivf_bq.search(..., backend="reference")``
(the jnp scan, bit-identical to its Pallas kernel by the JAX package's own
tests). Tolerances:

- ``_encode_math``: codes bit-equal; scale and bias within rtol 1e-5 plus
  an absolute floor of 1e-5 × the largest |value| (the L2 bias sums terms
  of size ‖c‖², so where it cancels it keeps their fp32 noise);
- search candidates: ``topk_agreement`` at rtol 5e-4, an absolute floor of
  5e-4 × the largest ‖q‖² (the scan ranks scores of that size; adding ‖q‖²
  back cancels most of it) and ids equal except at near-ties;
- refined recall@10: within 0.005 of JAX's on the carried-across index,
  within 0.02 of the JAX-built index's for a port-built one (the two draw
  their k-means samples and rotations from different generators).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_bq as jbq
from raft_tpu.ops import distance as jdist
from raft_tpu.ops import linalg as jlin
from raft_tpu.stats import metrics as jmet
from raft_tpu_torch.bench.datasets import sift_like
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.neighbors import ivf_bq as tbq
from raft_tpu_torch.ops import distance as tdist
from raft_tpu_torch.ops import linalg as tlin
from raft_tpu_torch.serving import PagedListStore
from raft_tpu_torch.stats import metrics as tmet

torch.set_num_threads(2)

PARAMS = dict(n_lists=32, kmeans_trainset_fraction=0.5)
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
    return jbq.build(data[0], jbq.IvfBqParams(**PARAMS))


def _carried(jidx):
    meta = {"kind": "ivf_bq", "metric": jidx.metric, "bits": jidx.bits,
            "rotation_kind": jidx.rotation_kind}
    arrays = {k: np.asarray(getattr(jidx, k)) for k in
              ("centers", "rotation", "list_codes", "list_ids", "list_scale",
               "list_bias")}
    return tbq.from_jax_arrays(meta, arrays, device=CPU)


def _recall_jax(idx, data, gt, kf, p):
    ds, qs = data
    v, i = jbq.search_refined(idx, ds, qs, 10, n_probes=p,
                              refine_ratio=kf // 10)
    return float(jmet.neighborhood_recall(i, gt[1], v, gt[0]))


def _recall_port(idx, data, gt, kf, p):
    ds, qs = data
    v, i = tbq.search_refined(idx, ds, qs, 10, n_probes=p,
                              refine_ratio=kf // 10, device=CPU)
    return tmet.neighborhood_recall(i, torch.from_numpy(gt[1]), v,
                                    torch.from_numpy(gt[0]))


def _assert_search_agrees(jidx, qs, kf, n_probes):
    jv, ji = jbq.search(jidx, qs, kf, n_probes=n_probes, backend="reference")
    tv, ti = tbq.search(_carried(jidx), qs, kf, n_probes=n_probes, device=CPU)
    atol = 5e-4 * float((qs.astype(np.float64) ** 2).sum(1).max())
    verdict = tmet.topk_agreement(torch.from_numpy(np.array(jv)),
                                  torch.from_numpy(np.array(ji)), tv, ti,
                                  rtol=5e-4, atol=atol, tie_rtol=1e-3)
    assert verdict["ok"], verdict
    assert verdict["compared"] > 0


@pytest.mark.parametrize("kf,n_probes", [(40, 4), (20, 4), (10, 8)])
def test_search_on_jax_index_matches(data, jax_index, kf, n_probes):
    _assert_search_agrees(jax_index, data[1], kf, n_probes)


@pytest.mark.parametrize("metric,bits,rotation_kind", [
    ("inner_product", 1, "dense"), ("cosine", 2, "hadamard"),
    ("sqeuclidean", 4, "hadamard")])
def test_search_matches_across_metrics_and_codes(data, metric, bits,
                                                 rotation_kind):
    ds, qs = data[0][:4000], data[1][:100]
    jidx = jbq.build(ds, jbq.IvfBqParams(n_lists=16, metric=metric, bits=bits,
                                         rotation_kind=rotation_kind,
                                         kmeans_n_iters=10))
    _assert_search_agrees(jidx, qs, 20, 3)


@pytest.mark.parametrize("kf,n_probes", [(40, 4), (80, 6)])
def test_refined_recall_on_jax_index_within_0_005(data, gt, jax_index, kf,
                                                   n_probes):
    want = _recall_jax(jax_index, data, gt, kf, n_probes)
    got = _recall_port(_carried(jax_index), data, gt, kf, n_probes)
    assert abs(got - want) <= 0.005, (got, want)


@pytest.mark.parametrize("rotation_kind", ["dense", "hadamard"])
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_encode_math_matches_jax(data, jax_index, bits, rotation_kind):
    rng = np.random.default_rng(bits)
    rows = data[0][:600]
    centers = np.asarray(jax_index.centers)
    labels = rng.integers(0, centers.shape[0], rows.shape[0]).astype(np.int32)
    rot_dim = tbq.auto_rot_dim(rows.shape[1], rotation_kind)
    if rotation_kind == "dense":
        rotation = np.asarray(jax_index.rotation)
    else:
        rotation = rng.choice([-1.0, 1.0], rot_dim).astype(np.float32)
    rc = jlin.rotate_rows(jnp.asarray(centers), jnp.asarray(rotation),
                          rotation_kind)
    want = jbq._encode_math(jnp.asarray(rows), jnp.asarray(labels),
                            jnp.asarray(centers), jnp.asarray(rotation), rc,
                            jdist.sqnorm(jnp.asarray(centers)), True, bits,
                            rotation_kind)
    t = torch.from_numpy
    trc = tlin.rotate_rows(t(centers), t(rotation), rotation_kind)
    got = tbq._encode_math(t(rows), t(labels), t(centers), t(rotation), trc,
                           tdist.sqnorm(t(centers)), True, bits, rotation_kind)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


@pytest.fixture(scope="module")
def port_index(data):
    return tbq.build(data[0], tbq.IvfBqParams(**PARAMS), device=CPU)


def test_port_built_index_invariants(port_index, data):
    R = port_index.rotation
    assert (R @ R.T - torch.eye(R.shape[0])).abs().max() <= 1e-5
    assert port_index.size == data[0].shape[0]
    assert port_index.max_list_size % 512 == 0
    assert port_index.code_bytes_per_row == 4
    ids = port_index.list_ids[port_index.list_ids >= 0]
    assert torch.equal(ids.sort().values, torch.arange(data[0].shape[0],
                                                       dtype=torch.int32))
    pad = port_index.list_ids < 0
    assert torch.isinf(port_index.list_bias[pad]).all()
    assert (port_index.list_scale[pad] == 0).all()
    assert torch.isfinite(port_index.list_bias[~pad]).all()
    assert (port_index.list_scale[~pad] > 0).all()


@pytest.mark.parametrize("kf,n_probes", [(40, 4), (80, 6)])
def test_port_built_recall_within_0_02(port_index, jax_index, data, gt, kf,
                                       n_probes):
    want = _recall_jax(jax_index, data, gt, kf, n_probes)
    got = _recall_port(port_index, data, gt, kf, n_probes)
    assert abs(got - want) <= 0.02, (got, want)


def test_port_built_hadamard_multibit_recall(data, gt):
    """bits 2 over the SRHT rotation: built and searched by the port, it
    ranks as well as the JAX package's build of the same configuration."""
    params = dict(PARAMS, bits=2, rotation_kind="hadamard")
    port = tbq.build(data[0], tbq.IvfBqParams(**params), device=CPU)
    assert port.rotation.shape == (32,)
    assert port.code_bytes_per_row == 8
    want = _recall_jax(jbq.build(data[0], jbq.IvfBqParams(**params)), data, gt,
                       20, 4)
    got = _recall_port(port, data, gt, 20, 4)
    assert abs(got - want) <= 0.02, (got, want)


def test_index_files_cross_both_ways(tmp_path, data, jax_index):
    _, qs = data
    jax_index.save(tmp_path / "jax.idx")
    port = tbq.IvfBqIndex.load(tmp_path / "jax.idx", device=CPU)
    for name, t in port.arrays().items():
        assert t.numpy().tobytes() == np.asarray(
            getattr(jax_index, name)).tobytes(), name
    assert (port.metric, port.bits, port.rotation_kind) == (
        jax_index.metric, jax_index.bits, jax_index.rotation_kind)
    port.save(tmp_path / "port.idx")
    back = jbq.IvfBqIndex.load(tmp_path / "port.idx")
    _, i1 = jbq.search(jax_index, qs[:50], 10, n_probes=4, backend="reference")
    _, i2 = jbq.search(back, qs[:50], 10, n_probes=4, backend="reference")
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_unknown_rotation_kind_is_refused(jax_index):
    meta = {"kind": "ivf_bq", "metric": "sqeuclidean",
            "rotation_kind": "givens"}
    arrays = {k: np.asarray(getattr(jax_index, k)) for k in
              ("centers", "rotation", "list_codes", "list_ids", "list_scale",
               "list_bias")}
    with pytest.raises(ValueError, match="rotation_kind"):
        tbq.from_jax_arrays(meta, arrays, device=CPU)
    with pytest.raises(ValueError, match="not an ivf_bq index"):
        tbq.from_jax_arrays({"kind": "ivf_pq"}, arrays, device=CPU)


def test_later_slice_features_raise(port_index, data):
    """What a later slice once brought now serves (filters, ``extend``,
    ``reconstruct_rows``, the paged filter); IVF-BQ's paged search still
    has no gather backend, and a streamed build refuses cosine."""
    ds, qs = data
    none = Bitset.create(port_index.size, False, device=CPU)
    v, i = tbq.search(port_index, qs, 10, filter=none, device=CPU)
    assert (i == -1).all() and torch.isinf(v).all()
    store = PagedListStore.from_index(port_index, page_rows=64, device=CPU)
    with pytest.raises(ValueError, match="unknown backend"):
        tbq.search_paged(store, qs, 10, backend="gather", device=CPU)
    v, i = tbq.search_paged(store, qs, 10, filter=none, device=CPU)
    assert (i == -1).all() and torch.isinf(v).all()
    assert tbq.extend(port_index, ds[:10], device=CPU).size == \
        port_index.size + 10
    with pytest.raises(ValueError, match="cosine"):
        tbq.build_streaming(None, 10, 32, tbq.IvfBqParams(metric="cosine"),
                            device=CPU)
    rows = tbq.reconstruct_rows(
        port_index.centers, port_index.rotation, port_index.list_codes[0],
        port_index.list_scale[0], torch.zeros(port_index.max_list_size,
                                              dtype=torch.int64))
    assert tuple(rows.shape) == (port_index.max_list_size, port_index.dim)


def test_params_validation():
    with pytest.raises(ValueError, match="bits"):
        tbq.IvfBqParams(bits=5)
    with pytest.raises(ValueError, match="rotation_kind"):
        tbq.IvfBqParams(rotation_kind="givens")
    assert tbq.IvfBqParams(metric="l2").metric == "sqeuclidean"
