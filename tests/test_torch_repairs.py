"""Port faults the port had against the JAX package, each held by a
parity test on the same input:

* ``stats.summary.cov`` takes JAX's ``(x, mu=None, sample=True,
  stable=True)`` with its defaults (the port had only the population
  covariance, off by n/(n−1) in the default call);
* ``ops.distance.fused_l2_nn_argmin(sqrt=True)`` returns distances;
* ``ops.select_k.select_k(algo="approx", recall_target=...)`` runs the
  exact select, which meets any recall target;
* ``neighbors.brute_force.search(select_algo=...)`` takes the JAX
  package's four selects.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.ops import distance as jdist
from raft_tpu.ops import select_k as jsel
from raft_tpu.stats import summary as jsum
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.ops import distance as tdist
from raft_tpu_torch.ops import select_k as tsel
from raft_tpu_torch.stats import summary as tsum

torch.set_num_threads(2)
CPU = "cpu"


@pytest.mark.parametrize("kw", [
    {}, {"sample": False}, {"sample": True}, {"stable": False},
    {"sample": False, "stable": False}, {"mu": "given"},
    {"mu": "given", "sample": False, "stable": False}])
def test_cov_matches_jax(kw):
    x = np.random.default_rng(0).standard_normal((50, 4)).astype(np.float32)
    kw = dict(kw)
    if kw.get("mu") == "given":
        kw["mu"] = np.array([0.1, -0.2, 0.3, 0.0], np.float32)
    want = np.asarray(jsum.cov(jnp.asarray(x), **kw))
    tkw = dict(kw)
    if "mu" in tkw:
        tkw["mu"] = torch.from_numpy(tkw["mu"])
    got = tsum.cov(torch.from_numpy(x), **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("m,n,dim", [(300, 17, 8), (1000, 64, 5)])
def test_fused_l2_nn_argmin_sqrt_matches_jax(m, n, dim):
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, dim)).astype(np.float32)
    y = rng.standard_normal((n, dim)).astype(np.float32)
    for sqrt in (True, False):
        jv, ji = jdist.fused_l2_nn_argmin(x, y, sqrt=sqrt)
        tv, ti = tdist.fused_l2_nn_argmin(torch.from_numpy(x),
                                          torch.from_numpy(y), sqrt=sqrt,
                                          workspace_bytes=1 << 14)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-5)
    d2, _ = tdist.fused_l2_nn_argmin(torch.from_numpy(x), torch.from_numpy(y))
    d, _ = tdist.fused_l2_nn_argmin(torch.from_numpy(x), torch.from_numpy(y),
                                    sqrt=True)
    torch.testing.assert_close(d, torch.sqrt(d2))


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("k,recall", [(1, 0.95), (10, 0.5), (64, 0.99)])
def test_select_k_approx_equals_jax_exact(select_min, k, recall):
    rng = np.random.default_rng(k)
    v = rng.standard_normal((12, 300)).astype(np.float32)
    v[:, 7] = v[:, 9]                       # a tie: lowest index first
    idx = rng.permutation(12 * 300).reshape(12, 300).astype(np.int32)
    jv, ji = jsel.select_k(v, k, select_min=select_min, indices=idx,
                           algo="exact")
    tv, ti = tsel.select_k(torch.from_numpy(v), k, select_min=select_min,
                           indices=torch.from_numpy(idx), algo="approx",
                           recall_target=recall)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    with pytest.raises(ValueError):
        tsel.select_k(torch.from_numpy(v), k, algo="bogus")


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product", "l1"])
@pytest.mark.parametrize("algo", ["exact", "iter", "packed", "approx"])
def test_brute_force_select_algo_matches_jax(metric, algo):
    rng = np.random.default_rng(3)
    data = rng.standard_normal((700, 16)).astype(np.float32)
    q = rng.standard_normal((40, 16)).astype(np.float32)
    k = 10
    # one tile in both packages, so "packed" packs the same row width
    jv, ji = jbf.search(jbf.build(data, metric=metric), q, k,
                        select_algo=algo)
    tv, ti = tbf.search(tbf.build(data, metric=metric, device=CPU), q, k,
                        select_algo=algo, device=CPU)
    jv, ji = np.asarray(jv), np.asarray(ji)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-5, atol=1e-5)
    diff = ti.numpy() != ji
    if diff.any():       # ids differ only where values tie
        close = np.isclose(tv.numpy(), jv, rtol=1e-5, atol=1e-5)
        assert close[diff].all()
        assert diff.mean() < 0.01


def test_brute_force_select_algo_over_tiles_and_bad_name():
    rng = np.random.default_rng(4)
    data = rng.standard_normal((900, 8)).astype(np.float32)
    q = rng.standard_normal((20, 8)).astype(np.float32)
    idx = tbf.build(data, device=CPU)
    ref_v, ref_i = tbf.search(idx, q, 7, tile_rows=900, device=CPU)
    for algo in ("exact", "iter", "approx"):
        v, i = tbf.search(idx, q, 7, tile_rows=256, select_algo=algo,
                          device=CPU)
        torch.testing.assert_close(v, ref_v, rtol=0, atol=0)
        torch.testing.assert_close(i, ref_i, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tbf.search(idx, q, 7, select_algo="bogus", device=CPU)
