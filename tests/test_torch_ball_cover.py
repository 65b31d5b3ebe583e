"""Port parity: raft_tpu_torch.neighbors.ball_cover and
epsilon_neighborhood against the JAX package on the same numpy rows.

The JAX package draws its landmarks with ``jax.random.choice``, which torch
cannot reproduce, so search parity carries a JAX-built
``BallCoverIndex`` into the port by its arrays: ``knn_query`` (euclidean,
sqeuclidean, haversine) and ``all_knn_query`` give JAX's values at rtol
1e-5 plus an absolute 2e-6 of the largest squared norm (euclidean
distances compared as their squares) and its ids but at near-ties; ``eps_nn`` gives JAX's adjacency
matrix and degrees exactly. A port-built index is judged by exactness
against brute force. ``eps_neighbors`` equals JAX's matrix and degrees.
"""

import numpy as np
import pytest
import torch

from raft_tpu.neighbors import ball_cover as jbc
from raft_tpu.neighbors import epsilon_neighborhood as jeps
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import ball_cover as tbc
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import epsilon_neighborhood as teps
from raft_tpu_torch.stats import metrics as tmet

torch.set_num_threads(2)
CPU = "cpu"


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(31)
    centers = rng.standard_normal((8, 6)) * 4
    x = (centers[rng.integers(0, 8, 1500)]
         + rng.standard_normal((1500, 6))).astype(np.float32)
    q = (centers[rng.integers(0, 8, 80)]
         + rng.standard_normal((80, 6))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def sphere():
    rng = np.random.default_rng(32)
    x = np.stack([rng.uniform(-1.2, 1.2, 800), rng.uniform(-3.1, 3.1, 800)],
                 1).astype(np.float32)
    q = (x[:40] + rng.normal(0, 0.01, (40, 2))).astype(np.float32)
    return x, q


def carried(j):
    return tbc.BallCoverIndex(*[torch.from_numpy(np.array(a)) for a in
                                (j.landmarks, j.list_data, j.list_ids,
                                 j.radii)], j.metric)


def assert_agree(jv, ji, tv, ti, scale, squared=False):
    """Values at rtol 1e-5 and an absolute 2e-6 of ``scale`` (the largest
    squared norm for the L2 metrics, whose expanded form cancels it);
    ``squared`` compares euclidean distances as their squares."""
    jv = torch.from_numpy(np.array(jv))
    if squared:
        jv, tv = jv * jv, tv * tv
    verdict = tmet.topk_agreement(jv, torch.from_numpy(np.array(ji)), tv, ti,
                                  rtol=1e-5, atol=2e-6 * scale,
                                  tie_rtol=1e-4)
    assert verdict["ok"] and verdict["compared"] > 0, verdict


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean"])
@pytest.mark.parametrize("k,batch", [(1, 8), (7, 8), (10, 3)])
def test_knn_query_on_jax_index_matches(rows, metric, k, batch):
    x, q = rows
    j = jbc.build(x, metric=metric)
    jv, ji = jbc.knn_query(j, q, k, batch=batch)
    tv, ti = tbc.knn_query(carried(j), q, k, batch=batch, device=CPU)
    scale = float((x.astype(np.float64) ** 2).sum(1).max())
    assert_agree(jv, ji, tv, ti, scale, squared=metric == "euclidean")


def test_haversine_query_on_jax_index_matches(sphere):
    x, q = sphere
    j = jbc.build(x, metric="haversine")
    jv, ji = jbc.knn_query(j, q, 5)
    tv, ti = tbc.knn_query(carried(j), q, 5, device=CPU)
    assert_agree(jv, ji, tv, ti, 1.0)


def test_all_knn_query_on_jax_index_matches(rows):
    x, _ = rows
    j = jbc.build(x[:600], metric="sqeuclidean")
    jv, ji = jbc.all_knn_query(j, 4)
    tv, ti = tbc.all_knn_query(carried(j), 4, device=CPU)
    scale = float((x.astype(np.float64) ** 2).sum(1).max())
    assert_agree(jv, ji, tv, ti, scale)


@pytest.mark.parametrize("eps", [0.8, 2.5])
def test_eps_nn_on_jax_index_equals_jax(rows, eps):
    x, q = rows
    j = jbc.build(x, metric="euclidean")
    jadj, jdeg = jbc.eps_nn(j, q, eps)
    tadj, tdeg = tbc.eps_nn(carried(j), q, eps, device=CPU)
    np.testing.assert_array_equal(tadj.numpy(), np.asarray(jadj))
    np.testing.assert_array_equal(tdeg.numpy(), np.asarray(jdeg))
    # tiled over queries (a workspace of a few queries) the same
    tiny = Resources(device=CPU, workspace_bytes=1 << 16)
    tadj2, _ = tbc.eps_nn(carried(j), q, eps, res=tiny)
    assert torch.equal(tadj2, tadj)


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean"])
def test_port_built_index_is_exact(rows, metric):
    x, q = rows
    idx = tbc.build(x, metric=metric, seed=3, device=CPU)
    assert idx.size == x.shape[0] and idx.n_landmarks == int(1500 ** 0.5)
    bv, bi = tbf.search(tbf.build(x, metric=metric, device=CPU), q, 10,
                        device=CPU)
    v, i = tbc.knn_query(idx, q, 10, device=CPU)
    scale = float((x.astype(np.float64) ** 2).sum(1).max())
    squared = metric == "euclidean"
    assert_agree(bv.numpy(), bi.numpy(), v, i, scale, squared)
    # a workspace of a few queries per tile gives the same answer
    tiny = Resources(device=CPU, workspace_bytes=1 << 16)
    v2, i2 = tbc.knn_query(idx, q, 10, res=tiny)
    assert_agree(v.numpy(), i.numpy(), v2, i2, scale, squared)


def test_port_built_haversine_is_exact(sphere):
    x, q = sphere
    idx = tbc.build(x, metric="haversine", device=CPU)
    bv, bi = tbf.search(tbf.build(x, metric="haversine", device=CPU), q, 5,
                        device=CPU)
    v, i = tbc.knn_query(idx, q, 5, device=CPU)
    assert_agree(bv.numpy(), bi.numpy(), v, i, 1.0)


def test_port_built_eps_nn_equals_eps_neighbors(rows):
    x, q = rows
    idx = tbc.build(x, device=CPU)
    adj, deg = tbc.eps_nn(idx, q, 2.0, device=CPU)
    adj2, deg2 = teps.eps_neighbors(q, x, 2.0, device=CPU)
    assert int((adj != adj2).sum()) <= 2           # boundary pairs only
    assert int((deg - deg2).abs().sum()) <= 2


@pytest.mark.parametrize("eps", [0.5, 1.7, 4.0])
def test_eps_neighbors_equals_jax(rows, eps):
    x, q = rows
    jadj, jdeg = jeps.eps_neighbors(q, x[:500], eps)
    tadj, tdeg = teps.eps_neighbors(q, x[:500], eps, device=CPU)
    np.testing.assert_array_equal(tadj.numpy(), np.asarray(jadj))
    np.testing.assert_array_equal(tdeg.numpy(), np.asarray(jdeg))
    assert tdeg.dtype == torch.int32


def test_rejects_what_jax_rejects(rows):
    x, q = rows
    with pytest.raises(ValueError, match="ball_cover supports"):
        tbc.build(x[:50], metric="cosine", device=CPU)
    with pytest.raises(ValueError, match="n_landmarks"):
        tbc.build(x[:50], n_landmarks=60, device=CPU)
    idx = tbc.build(x[:100], device=CPU)
    with pytest.raises(ValueError, match="out of range"):
        tbc.knn_query(idx, q, 0, device=CPU)
    with pytest.raises(ValueError, match="queries must be"):
        tbc.knn_query(idx, q[:, :3], 2, device=CPU)
    with pytest.raises(ValueError, match="eps"):
        tbc.eps_nn(idx, q, 0.0, device=CPU)
    with pytest.raises(ValueError, match="eps"):
        teps.eps_neighbors(q, x, -1.0, device=CPU)
