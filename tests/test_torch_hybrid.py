"""Port parity: raft_tpu_torch.neighbors.hybrid against
raft_tpu.neighbors.hybrid on the same numpy rows.

- the feature hash's ``col`` / ``sign`` are bit-equal, and both packages
  raise ``OverflowError`` for a seed whose ``seed·0x9E3779B9 + 1`` leaves
  uint32 (every seed ≥ 2, and negative seeds);
- ``project_sparse``: the port's dense, CSR and COO forms are bit-equal to
  one another and to the JAX package's CSR form (one scatter, colliding
  terms summed in term order); the JAX dense form is a matmul, held at
  atol 1e-6;
- search on a JAX-built ``HybridIndex`` carried across by its arrays:
  ``topk_agreement`` at rtol 5e-4, an absolute floor of 5e-4 × the largest
  ‖q‖², ids equal but at near-ties;
- a port-built index's recall@10 (over-fetch 8×, exact re-rank over the
  fused rows) within 0.005 of the JAX-built index's;
- ``to_store`` → ``serving.search`` over fused queries equals
  ``hybrid.search`` (ids but at near-ties).

The JAX reference scans with ``backend="reference"`` (its jnp scan,
bit-identical to its Pallas kernel by the JAX package's own tests).
"""

import numpy as np
import pytest
import torch

from raft_tpu.neighbors import hybrid as jh
from raft_tpu.neighbors import ivf_bq as jbq
from raft_tpu.sparse import coo_from_dense as jcoo
from raft_tpu.sparse import csr_from_dense as jcsr
from raft_tpu_torch import serving
from raft_tpu_torch.bench.datasets import sift_like
from raft_tpu_torch.neighbors import hybrid as th
from raft_tpu_torch.neighbors import ivf_bq as tbq
from raft_tpu_torch.neighbors import refine
from raft_tpu_torch.sparse import coo_from_dense as tcoo
from raft_tpu_torch.sparse import csr_from_dense as tcsr
from raft_tpu_torch.stats import metrics as tmet

torch.set_num_threads(2)
CPU = "cpu"
SDIM = 64
PARAMS = dict(n_lists=16, metric="inner_product",
              kmeans_trainset_fraction=0.5)


def sparse_rows(seed, n, vocab=300, density=0.03):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, vocab)) < density)
            * rng.random((n, vocab))).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("sparse_dim", [7, 64, 256, 1000])
def test_hash_columns_and_signs_are_bitwise(seed, sparse_dim):
    ids = np.concatenate([np.arange(2000),
                          np.random.default_rng(seed).integers(
                              0, 2 ** 31 - 1, 3000)]).astype(np.int32)
    jc, js = jh._hash_cols_signs(ids, sparse_dim, seed)
    tc, ts = th._hash_cols_signs(torch.from_numpy(ids), sparse_dim, seed)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tc.dtype == torch.int32 and ts.dtype == torch.float32


@pytest.mark.parametrize("seed", [2, 7, -1])
def test_seed_overflow_is_mirrored(seed):
    """``seed·0x9E3779B9 + 1`` must fit uint32; both packages raise."""
    with pytest.raises(OverflowError):
        jh._hash_cols_signs(np.arange(4), 16, seed)
    with pytest.raises(OverflowError):
        th._hash_cols_signs(torch.arange(4), 16, seed)
    with pytest.raises(OverflowError):
        th.project_sparse(sparse_rows(0, 4), 16, seed=seed, device=CPU)


@pytest.mark.parametrize("seed", [0, 1])
def test_projection_forms_agree(seed):
    sp = sparse_rows(3 + seed, 200)
    cap = int(np.count_nonzero(sp)) + 11      # padding contributes zero
    dense = th.project_sparse(sp, SDIM, seed, device=CPU)
    csr = th.project_sparse(tcsr(sp, cap, device=CPU), SDIM, seed)
    coo = th.project_sparse(tcoo(sp, cap, device=CPU), SDIM, seed)
    assert torch.equal(dense, csr) and torch.equal(dense, coo)
    j_csr = np.asarray(jh.project_sparse(jcsr(sp, cap), SDIM, seed))
    j_coo = np.asarray(jh.project_sparse(jcoo(sp, cap), SDIM, seed))
    j_dense = np.asarray(jh.project_sparse(sp, SDIM, seed))
    np.testing.assert_array_equal(csr.numpy(), j_csr)
    np.testing.assert_array_equal(coo.numpy(), j_coo)
    np.testing.assert_allclose(dense.numpy(), j_dense, rtol=0, atol=1e-6)
    # a permuted COO (padding in the middle) projects the same
    perm = np.random.default_rng(seed).permutation(cap)
    c = tcoo(sp, cap, device=CPU)
    from raft_tpu_torch.sparse import COO
    shuffled = COO(c.rows[perm], c.cols[perm], c.vals[perm], c.shape)
    assert torch.equal(th.project_sparse(shuffled, SDIM, seed), dense)


def test_sparse_dim_default_follows_the_env_knob(monkeypatch):
    sp = sparse_rows(5, 8)
    monkeypatch.setenv(th.HYBRID_SPARSE_DIM_ENV, "32")
    assert th.default_hybrid_sparse_dim() == jh.default_hybrid_sparse_dim() \
        == 32
    assert th.project_sparse(sp, device=CPU).shape == (8, 32)
    monkeypatch.delenv(th.HYBRID_SPARSE_DIM_ENV)
    assert th.default_hybrid_sparse_dim() == 256
    with pytest.raises(ValueError, match="sparse_dim"):
        th.project_sparse(sp, 0, device=CPU)


@pytest.fixture(scope="module")
def data():
    ds, qs = sift_like(10_000, 32, 500, seed=3)
    sp = sparse_rows(13, 10_500)
    return (ds.astype(np.float32) / 50, qs.astype(np.float32) / 50,
            sp[:10_000], sp[10_000:])


@pytest.fixture(scope="module")
def jax_hybrid(data):
    ds, _, sx, _ = data
    return jh.build(ds, sx, jbq.IvfBqParams(**PARAMS), sparse_dim=SDIM)


@pytest.fixture(scope="module")
def port_hybrid(data):
    ds, _, sx, _ = data
    return th.build(ds, sx, tbq.IvfBqParams(**PARAMS), sparse_dim=SDIM,
                    device=CPU)


def carried(jhy):
    j = jhy.index
    meta = {"kind": "ivf_bq", "metric": j.metric, "bits": j.bits,
            "rotation_kind": j.rotation_kind}
    arrays = {k: np.asarray(getattr(j, k)) for k in
              ("centers", "rotation", "list_codes", "list_ids", "list_scale",
               "list_bias")}
    return th.HybridIndex(tbq.from_jax_arrays(meta, arrays, device=CPU),
                          jhy.dense_dim, jhy.sparse_dim, jhy.beta, jhy.seed)


@pytest.mark.parametrize("k,n_probes", [(10, 4), (80, 16)])
def test_search_on_jax_index_matches(data, jax_hybrid, k, n_probes):
    _, qs, _, sq = data
    jv, ji = jh.search(jax_hybrid, qs, sq, k, n_probes=n_probes,
                       backend="reference")
    tv, ti = th.search(carried(jax_hybrid), qs, sq, k, n_probes=n_probes,
                       device=CPU)
    fq = th.fuse_queries(carried(jax_hybrid), qs, sq)
    atol = 5e-4 * float((fq.double() ** 2).sum(1).max())
    verdict = tmet.topk_agreement(torch.from_numpy(np.array(jv)),
                                  torch.from_numpy(np.array(ji)), tv, ti,
                                  rtol=5e-4, atol=atol, tie_rtol=1e-3)
    assert verdict["ok"] and verdict["compared"] > 0, verdict


def fused_truth(data, hy):
    ds, qs, sx, sq = data
    rows = torch.cat([torch.from_numpy(ds),
                      hy.beta * th.project_sparse(sx, SDIM, device=CPU)], 1)
    fq = th.fuse_queries(hy, qs, sq)
    return rows, fq, torch.topk(fq @ rows.T, 10).indices


def reranked_recall(data, hy, search):
    rows, fq, gt = fused_truth(data, hy)
    _, cand = search(80, 16)
    _, ids = refine.refine(rows, fq, torch.as_tensor(np.array(cand)), 10,
                           metric="inner_product", device=CPU)
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                          for a, b in zip(ids, gt)]))


def test_port_built_recall_matches_jax_built(data, jax_hybrid, port_hybrid):
    _, qs, _, sq = data
    want = reranked_recall(data, port_hybrid, lambda k, p: jh.search(
        jax_hybrid, qs, sq, k, n_probes=p, backend="reference"))
    got = reranked_recall(data, port_hybrid, lambda k, p: th.search(
        port_hybrid, qs, sq, k, n_probes=p, device=CPU))
    assert got >= want - 0.005, (got, want)
    assert want > 0.9


def test_to_store_search_equals_hybrid_search(data, port_hybrid):
    _, qs, _, sq = data
    store = th.to_store(port_hybrid, page_rows=64, device=CPU)
    fq = th.fuse_queries(port_hybrid, qs, sq)
    sv, si = serving.search(store, fq, 10, n_probes=8, device=CPU)
    hv, hi = th.search(port_hybrid, qs, sq, 10, n_probes=8, device=CPU)
    atol = 5e-4 * float((fq.double() ** 2).sum(1).max())
    verdict = tmet.topk_agreement(hv, hi, sv, si, rtol=5e-4, atol=atol,
                                  tie_rtol=1e-3)
    assert verdict["ok"] and verdict["compared"] > 0, verdict


def test_build_rejects_what_jax_rejects(data):
    ds, _, sx, _ = data
    with pytest.raises(ValueError, match="inner_product"):
        th.build(ds[:100], sx[:100], tbq.IvfBqParams(n_lists=2),
                 device=CPU)
    with pytest.raises(ValueError, match="rows"):
        th.build(ds[:100], sx[:90], tbq.IvfBqParams(**{**PARAMS,
                                                        "n_lists": 2}),
                 device=CPU)
    tiny = th.build(ds[:64], sx[:64], tbq.IvfBqParams(
        n_lists=2, metric="inner_product"), sparse_dim=8, device=CPU)
    assert tiny.dim == 40 and tiny.n_lists == 2
    with pytest.raises(ValueError, match="queries must be"):
        th.fuse_queries(tiny, ds[:2, :8], sx[:2])
