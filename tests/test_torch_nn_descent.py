"""NN-descent and the CAGRA build it feeds, in the PyTorch port, against
the JAX package on the same numpy inputs: the payload merge bit for bit
(ties included), the graph by recall against the exact kNN graph (the two
packages' random streams differ), validation, the deadline checkpoint and
``cagra.build(build_algo="nn_descent")``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.bench.datasets import sift_like
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import nn_descent as jnnd
from raft_tpu.ops import segment as jseg
from raft_tpu_torch import resilience
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tc
from raft_tpu_torch.neighbors import nn_descent as tnnd
from raft_tpu_torch.ops import segment as tseg

torch.set_num_threads(2)
CPU = {"device": "cpu"}


def _graph_recall(graph, exact):
    graph, exact = np.asarray(graph), np.asarray(exact)
    k = exact.shape[1]
    return float(np.mean([len(set(g[:k]) & set(e)) / k
                          for g, e in zip(graph, exact)]))


def _merge_case(seed, n, a, b, ties):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, 40, (n, a)).astype(np.int32)
    cand = rng.integers(-1, 40, (n, b)).astype(np.int32)
    if ties:      # few distinct distances: ties between ids and copies
        d = rng.integers(0, 4, (n, a)).astype(np.float32)
        cd = rng.integers(0, 4, (n, b)).astype(np.float32)
    else:
        d = rng.random((n, a)).astype(np.float32)
        cd = rng.random((n, b)).astype(np.float32)
    d[ids < 0] = np.inf
    cd[cand < 0] = np.inf
    p = rng.random((n, a)) < 0.5
    cp = rng.random((n, b)) < 0.5
    return ids, d, cand, cd, p, cp


@pytest.mark.parametrize("seed,ties,self_", [(0, True, True), (1, True, False),
                                             (2, False, True)])
def test_merge_topk_dedup_with_payload_is_bitwise_jax(seed, ties, self_):
    ids, d, cand, cd, p, cp = _merge_case(seed, 64, 12, 9, ties)
    k = 10
    rows = np.arange(64, dtype=np.int32) % 40
    want = jseg.merge_topk_dedup(
        jnp.asarray(ids), jnp.asarray(d), jnp.asarray(cand), jnp.asarray(cd),
        k, exclude_self=jnp.asarray(rows) if self_ else None,
        payload=jnp.asarray(p), cand_payload=jnp.asarray(cp))
    got = tseg.merge_topk_dedup(
        torch.from_numpy(ids), torch.from_numpy(d), torch.from_numpy(cand),
        torch.from_numpy(cd), k,
        exclude_self=torch.from_numpy(rows) if self_ else None,
        payload=torch.from_numpy(p), cand_payload=torch.from_numpy(cp))
    assert len(got) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def knn_data():
    data, _ = sift_like(2000, 16, 8, seed=3)
    X = data.astype(np.float32)
    _, nn = jbf.knn(X, X, 17)
    exact = np.asarray(nn)[:, 1:]
    return X, exact


def test_graph_recall_is_at_least_the_jax_builds(knn_data):
    X, exact = knn_data
    params = dict(graph_degree=16, intermediate_graph_degree=32,
                  max_iterations=10, sample_size=8, seed=0)
    jg = np.asarray(jnnd.build(X, jnnd.NNDescentParams(**params)))
    stats = {}
    tg, td = tnnd.build(X, tnnd.NNDescentParams(**params),
                        return_distances=True, stats=stats, **CPU)
    assert tg.shape == (2000, 16) and tg.dtype == torch.int32
    j_rec = _graph_recall(jg, exact)
    t_rec = _graph_recall(tg.numpy(), exact)
    assert t_rec >= j_rec - 0.02, (t_rec, j_rec)
    assert 1 <= stats["iterations"] <= 10
    # rows sorted by distance, no self edge, no duplicates, exact distances
    g, d = tg.numpy(), td.numpy()
    assert (np.diff(d, axis=1) >= 0).all()
    assert not (g == np.arange(2000)[:, None]).any()
    assert all(len(set(r)) == len(r) for r in g)
    want = ((X[:, None, :] - X[g]) ** 2).sum(-1)
    np.testing.assert_allclose(d, want, rtol=1e-4, atol=1e-3)


def test_params_validation():
    with pytest.raises(ValueError, match="graph_degree"):
        tnnd.NNDescentParams(graph_degree=64, intermediate_graph_degree=32)
    with pytest.raises(ValueError, match="sample_size"):
        tnnd.NNDescentParams(sample_size=0)
    with pytest.raises(ValueError, match="at least 2 rows"):
        tnnd.build(np.zeros((1, 4), np.float32), **CPU)


def test_spent_deadline_keeps_the_first_round_marked_degraded(knn_data):
    X, _ = knn_data
    params = tnnd.NNDescentParams(graph_degree=8, intermediate_graph_degree=16,
                                  max_iterations=6)
    stats = {}
    with resilience.Deadline(0.0, hard=False) as dl:
        g = tnnd.build(X[:500], params, stats=stats, **CPU)
    assert stats["iterations"] == 1 and g.shape == (500, 8)
    assert dl.degraded


def test_cagra_builds_from_nn_descent():
    data, Q = sift_like(2100, 16, 40, seed=4)   # past the 2,048-row brute
    params = tc.CagraParams(intermediate_graph_degree=16, graph_degree=12,
                            build_algo="nn_descent", nn_descent_niter=3)
    idx = tc.build(data, params, **CPU)
    assert idx.graph.shape == (2100, 12)
    assert "knn_graph" in idx.build_timings_s
    _, ids = tc.search(idx, Q, 10, tc.CagraSearchParams(itopk_size=64), **CPU)
    _, gt = tbf.search(tbf.build(data, **CPU), Q, 10, **CPU)
    assert _graph_recall(ids.numpy(), gt.numpy()) >= 0.9
