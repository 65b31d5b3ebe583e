"""Port parity: raft_tpu_torch.sparse against raft_tpu.sparse on the same
numpy inputs.

Containers, conversions and structural ops move entries without
arithmetic, so they are held bit for bit. Segment sums (spmv, spmm,
laplacian, row norms) are held at rtol 1e-5: the two packages add in
different orders. Pairwise distances at rtol 1e-5 (atol 1e-5 for values
near zero), every metric and backend. kNN graph ids equal but at
near-ties. The MST takes the JAX package's own graph, so its edges, count,
weights and colours are equal bit for bit, the forest and tie-heavy cases
of ``tests/test_sparse.py`` included. Lanczos draws its start vectors from
different streams, so it is judged by eigenvalues (atol 1e-4) and by
|cos| ≥ 0.999 between the packages' eigenvectors of a well-separated
eigenvalue (a degenerate one's eigenspace by its projection).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from raft_tpu import sparse as J
from raft_tpu.sparse import convert as jconv
from raft_tpu.sparse import distance as jdist
from raft_tpu.sparse import linalg as jlin
from raft_tpu.sparse import neighbors as jnb
from raft_tpu.sparse import op as jop
from raft_tpu.sparse import solver as jsol
from raft_tpu_torch import sparse as T
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.sparse import convert as tconv
from raft_tpu_torch.sparse import distance as tdist
from raft_tpu_torch.sparse import linalg as tlin
from raft_tpu_torch.sparse import neighbors as tnb
from raft_tpu_torch.sparse import op as top
from raft_tpu_torch.sparse import solver as tsol

torch.set_num_threads(2)
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _jitted_jax_symmetrize():
    """The JAX package's ``symmetrize`` under ``jax.jit`` for this module:
    the same values (its eager ``associative_scan`` compiles op by op,
    ~15 s a new shape on the CPU). The package itself is not changed."""
    import jax
    from raft_tpu.sparse import linalg as jax_linalg

    eager = jax_linalg.symmetrize
    jax_linalg.symmetrize = jax.jit(eager, static_argnames=("mode",))
    yield
    jax_linalg.symmetrize = eager


def random_dense(seed, n, m, density=0.1):
    rng = np.random.default_rng(seed)
    d = sp.random(n, m, density=density, random_state=rng, dtype=np.float32)
    return d.toarray()


def to_t(c):
    """A JAX container's arrays as the port's container, on the CPU."""
    if isinstance(c, J.COO):
        return T.COO(*[torch.from_numpy(np.array(a))
                       for a in (c.rows, c.cols, c.vals)], shape=c.shape)
    return T.CSR(*[torch.from_numpy(np.array(a))
                   for a in (c.indptr, c.indices, c.data)], shape=c.shape)


def same(j, t):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return j.shape == t.shape and j.dtype == t.dtype and np.array_equal(j, t)


def same_coo(j, t):
    return (same(j.rows, t.rows) and same(j.cols, t.cols)
            and same(j.vals, t.vals) and tuple(j.shape) == tuple(t.shape))


def same_csr(j, t):
    return (same(j.indptr, t.indptr) and same(j.indices, t.indices)
            and same(j.data, t.data) and tuple(j.shape) == tuple(t.shape))


CASES = [(0, 30, 20, 0.2, 0), (1, 17, 41, 0.1, 7), (2, 64, 8, 0.5, 3),
         (3, 5, 5, 0.0, 2)]


@pytest.mark.parametrize("seed,n,m,density,pad", CASES)
def test_containers_and_conversions_are_bitwise(seed, n, m, density, pad):
    d = random_dense(seed, n, m, density)
    cap = max(1, int(np.count_nonzero(d))) + pad
    jcoo, tcoo = J.coo_from_dense(d, cap), T.coo_from_dense(d, cap, device=CPU)
    assert same_coo(jcoo, tcoo)
    assert same(jcoo.valid, tcoo.valid) and int(jcoo.nnz()) == int(tcoo.nnz())
    jcsr, tcsr = J.csr_from_dense(d, cap), T.csr_from_dense(d, cap, device=CPU)
    assert same_csr(jcsr, tcsr)
    assert same(jcsr.row_ids(), tcsr.row_ids())
    assert int(jcsr.nnz()) == int(tcsr.nnz())
    assert same(jcoo.to_dense(), tcoo.to_dense())
    assert same(jcsr.to_dense(), tcsr.to_dense())
    assert same_coo(jconv.csr_to_coo(jcsr), tconv.csr_to_coo(tcsr))
    assert same_csr(jconv.coo_to_csr(jcoo), tconv.coo_to_csr(tcoo))
    # an unsorted COO with padding in the middle sorts to the same order
    perm = np.random.default_rng(seed).permutation(cap)
    rows = np.array(jcoo.rows)[perm]
    cols = np.array(jcoo.cols)[perm]
    vals = np.array(jcoo.vals)[perm]
    jp = J.coo_from_parts(rows, cols, vals, (n, m))
    tp = T.coo_from_parts(rows, cols, vals, (n, m), device=CPU)
    assert same_coo(jp, tp)
    assert same_coo(jconv.coo_sort(jp), tconv.coo_sort(tp))


def test_capacity_too_small_raises():
    with pytest.raises(ValueError, match="capacity"):
        T.coo_from_dense(np.eye(3, dtype=np.float32), 2, device=CPU)


@pytest.mark.parametrize("seed,n,m,density,pad", CASES[:3])
def test_structural_ops_are_bitwise(seed, n, m, density, pad):
    d = random_dense(seed, n, m, density)
    d[d > 0.8] = 0.5                      # a scalar to remove
    cap = max(1, int(np.count_nonzero(d))) + pad
    jcoo, tcoo = J.coo_from_dense(d, cap), T.coo_from_dense(d, cap, device=CPU)
    keep = np.random.default_rng(seed).random(cap) < 0.6
    assert same_coo(jop.filter_entries(jcoo, keep),
                    top.filter_entries(tcoo, torch.from_numpy(keep)))
    assert same_coo(jop.remove_scalar(jcoo, 0.5), top.remove_scalar(tcoo, 0.5))
    assert same_coo(jop.sort(jcoo), top.sort(tcoo))
    jcsr, tcsr = jconv.coo_to_csr(jcoo), tconv.coo_to_csr(tcoo)
    for a, b in ((0, n), (1, n // 2), (n // 3, n), (2, 2)):
        assert same_csr(jop.slice_rows(jcsr, a, b), top.slice_rows(tcsr, a, b))
    scales = np.random.default_rng(seed + 1).random(n).astype(np.float32)
    assert same_csr(jop.row_scale(jcsr, scales),
                    top.row_scale(tcsr, torch.from_numpy(scales)))
    with pytest.raises(ValueError, match="bad slice"):
        top.slice_rows(tcsr, 2, 1)


@pytest.mark.parametrize("seed,n,m,density,pad", CASES[:3])
def test_linalg_matches_jax(seed, n, m, density, pad):
    d = random_dense(seed, n, m, density)
    cap = max(1, int(np.count_nonzero(d))) + pad
    jcoo, tcoo = J.coo_from_dense(d, cap), T.coo_from_dense(d, cap, device=CPU)
    jcsr, tcsr = jconv.coo_to_csr(jcoo), tconv.coo_to_csr(tcoo)
    rng = np.random.default_rng(seed + 5)
    B = rng.standard_normal((m, 6)).astype(np.float32)
    x = B[:, 0].copy()
    np.testing.assert_allclose(tlin.spmm(tcsr, torch.from_numpy(B)).numpy(),
                               np.asarray(jlin.spmm(jcsr, B)), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tlin.spmv(tcsr, torch.from_numpy(x)).numpy(),
                               np.asarray(jlin.spmv(jcsr, x)), rtol=1e-5,
                               atol=1e-6)
    assert same_coo(jlin.transpose(jcoo), tlin.transpose(tcoo))
    assert same_coo(jlin.add(jcoo, jcoo), tlin.add(tcoo, tcoo))
    assert same(jlin.degree(jcoo), tlin.degree(tcoo))
    for norm in ("l1", "l2", "linf"):
        np.testing.assert_allclose(tlin.row_norm(tcsr, norm).numpy(),
                                   np.asarray(jlin.row_norm(jcsr, norm)),
                                   rtol=1e-5)
    with pytest.raises(ValueError, match="unknown norm"):
        tlin.row_norm(tcsr, "l3")


@pytest.mark.parametrize("mode", ["max", "sum", "mean"])
def test_symmetrize_matches_jax(mode):
    # the kNN-graph case's shapes (400², capacity 400·8): JAX compiles once
    d = random_dense(4, 400, 400, 0.019)
    cap = 3200
    jcoo, tcoo = J.coo_from_dense(d, cap), T.coo_from_dense(d, cap, device=CPU)
    js, ts = jlin.symmetrize(jcoo, mode), tlin.symmetrize(tcoo, mode)
    assert same(js.rows, ts.rows) and same(js.cols, ts.cols)
    np.testing.assert_array_equal(np.asarray(js.vals), ts.vals.numpy())
    np.testing.assert_allclose(ts.to_dense().numpy(),
                               np.asarray(js.to_dense()), rtol=1e-6)


@pytest.mark.parametrize("normalized", [False, True])
def test_laplacian_matches_jax(normalized):
    d = random_dense(5, 32, 32, 0.2)
    d = d + d.T
    cap = int(np.count_nonzero(d))
    jcoo, tcoo = J.coo_from_dense(d, cap), T.coo_from_dense(d, cap, device=CPU)
    jl, tl = jlin.laplacian(jcoo, normalized), tlin.laplacian(tcoo, normalized)
    assert same(jl.rows, tl.rows) and same(jl.cols, tl.cols)
    np.testing.assert_allclose(tl.vals.numpy(), np.asarray(jl.vals),
                               rtol=1e-5, atol=1e-6)


DENSE_METRICS = ["sqeuclidean", "euclidean", "inner_product", "cosine", "l1",
                 "chebyshev", "canberra", "hellinger", "jaccard",
                 "correlation"]


@pytest.fixture(scope="module")
def sparse_pair():
    xd = random_dense(6, 18, 40, 0.15)
    yd = random_dense(7, 13, 40, 0.15)
    out = []
    for dd, pad in ((xd, 3), (yd, 1)):
        cap = int(np.count_nonzero(dd)) + pad
        out.append((J.csr_from_dense(dd, cap), T.csr_from_dense(dd, cap,
                                                                device=CPU)))
    return out


@pytest.mark.parametrize("metric", DENSE_METRICS)
@pytest.mark.parametrize("backend", ["auto", "dense"])
def test_pairwise_distance_matches_jax(sparse_pair, metric, backend):
    (jx, tx), (jy, ty) = sparse_pair
    want = np.asarray(jdist.pairwise_distance(jx, jy, metric,
                                              backend=backend))
    got = tdist.pairwise_distance(tx, ty, metric, backend=backend,
                                  device=CPU).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean",
                                    "inner_product", "cosine"])
def test_expand_backend_matches_jax(sparse_pair, metric):
    (jx, tx), (jy, ty) = sparse_pair
    want = np.asarray(jdist.pairwise_distance(jx, jy, metric,
                                              backend="expand"))
    got = tdist.pairwise_distance(tx, ty, metric, backend="expand",
                                  device=CPU).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # tiled: a workspace that holds a few rows at a time gives the same
    tiny = Resources(device=CPU, workspace_bytes=4096)
    np.testing.assert_allclose(
        tdist.pairwise_distance(tx, ty, metric, backend="expand",
                                res=tiny).numpy(), got, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tdist.pairwise_distance(tx, ty, metric, res=tiny).numpy(),
        tdist.pairwise_distance(tx, ty, metric, device=CPU).numpy(),
        rtol=1e-6, atol=1e-6)


def test_distance_rejects_what_jax_rejects(sparse_pair):
    (_, tx), _ = sparse_pair
    with pytest.raises(ValueError, match="expand"):
        tdist.pairwise_distance(tx, tx, "l1", backend="expand", device=CPU)
    with pytest.raises(ValueError, match="unknown sparse distance backend"):
        tdist.pairwise_distance(tx, tx, backend="ell", device=CPU)


def test_brute_force_knn_matches_jax(sparse_pair):
    (jx, tx), (jy, ty) = sparse_pair
    jv, ji = jnb.brute_force_knn(jx, jy, 5)
    tv, ti = tnb.brute_force_knn(tx, ty, 5, device=CPU)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    near_tie = np.isclose(np.asarray(jv)[:, 1:], np.asarray(jv)[:, :-1],
                          rtol=1e-5)
    differ = ti.numpy() != np.asarray(ji)
    assert not (differ[:, 1:] & ~(near_tie | np.roll(near_tie, 1, 1))).any()


@pytest.fixture(scope="module")
def graph_rows():
    rng = np.random.default_rng(8)
    centers = rng.standard_normal((4, 6)) * 8
    X = (centers[rng.integers(0, 4, 400)]
         + rng.standard_normal((400, 6))).astype(np.float32)
    return X, jnb.knn_graph(X, 8)


def test_knn_graph_matches_jax_but_near_ties(graph_rows):
    X, jg = graph_rows
    tg = tnb.knn_graph(X, 8, device=CPU)
    assert tg.capacity == jg.capacity
    jd, td = np.asarray(jg.to_dense()), tg.to_dense().numpy()
    np.testing.assert_allclose(td, td.T)
    both = (jd > 0) & (td > 0)
    # the expanded ‖x‖² + ‖y‖² − 2⟨x, y⟩ cancels norms of ~10³ here, so
    # the two packages' fp32 products differ by ~1e-6 of the norms
    scale = float((X.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(td[both], jd[both], rtol=0, atol=1e-6 * scale)
    # an edge one package has and the other lacks sits at a near-tie of
    # an endpoint's 8th neighbour distance (exact, in float64)
    x64 = X.astype(np.float64)
    exact = ((x64[:, None, :] - x64[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(exact, np.inf)
    kth = np.sort(exact, axis=1)[:, 7]
    ri, ci = np.nonzero((jd > 0) != (td > 0))
    near = np.minimum(np.abs(exact[ri, ci] - kth[ri]),
                      np.abs(exact[ri, ci] - kth[ci]))
    assert (near <= 1e-6 * scale).all(), near.max()
    assert ri.size <= 0.01 * (jd > 0).sum()


def mst_pair(jgraph):
    return jsol.mst(jgraph), tsol.mst(to_t(jgraph))


def assert_mst_equal(jm, tm):
    assert same(jm.src, tm.src) and same(jm.dst, tm.dst)
    assert same(jm.weight, tm.weight) and int(jm.n_edges) == int(tm.n_edges)
    assert same(jm.color, tm.color)


def test_mst_equals_jax_on_its_knn_graph(graph_rows):
    _, jg = graph_rows
    jm, tm = mst_pair(jg)
    assert_mst_equal(jm, tm)
    assert same(jsol.connected_components(jg),
                tsol.connected_components(to_t(jg)))


def test_mst_equals_jax_on_a_forest():
    # two triangles, no bridge (tests/test_sparse.py's forest case)
    rows = np.array([0, 1, 0, 2, 1, 2, 3, 4, 3, 5, 4, 5], np.int32)
    cols = np.array([1, 0, 2, 0, 2, 1, 4, 3, 5, 3, 5, 4], np.int32)
    vals = np.array([1, 1, 2, 2, 3, 3, 1, 1, 2, 2, 3, 3], np.float32)
    jg = J.coo_from_parts(rows, cols, vals, (6, 6))
    jm, tm = mst_pair(jg)
    assert_mst_equal(jm, tm)
    assert int(tm.n_edges) == 4 and len(np.unique(tm.color.numpy())) == 2


@pytest.mark.parametrize("n", [16, 33])
def test_mst_equals_jax_on_tie_heavy_graphs(n):
    dense = np.ones((n, n), np.float32) - np.eye(n, dtype=np.float32)
    jm, tm = mst_pair(J.coo_from_dense(dense))
    assert_mst_equal(jm, tm)
    assert int(tm.n_edges) == n - 1


def test_mst_equals_jax_with_padding_and_isolated_vertices():
    rows = np.array([0, 1, -1, 2, 3, -1, 3, 2], np.int32)
    cols = np.array([1, 0, 0, 3, 2, 0, 2, 3], np.int32)
    vals = np.array([2, 2, 0, 5, 5, 0, 4, 4], np.float32)
    jg = J.coo_from_parts(rows, cols, vals, (6, 6))
    jm, tm = mst_pair(jg)
    assert_mst_equal(jm, tm)
    assert same(jsol.connected_components(jg),
                tsol.connected_components(to_t(jg)))


def test_mst_rejects_what_jax_rejects():
    g = T.coo_from_parts([0], [1], [1.0], (2, 3), device=CPU)
    with pytest.raises(ValueError, match="square"):
        tsol.mst(g)
    with pytest.raises(ValueError, match="2 vertices"):
        tsol.mst(T.coo_from_parts([0], [0], [1.0], (1, 1), device=CPU))


@pytest.mark.parametrize("normalized", [False, True])
def test_lanczos_eigenpairs_match_jax(graph_rows, normalized):
    """Four blobs, four components: the Laplacian's zero eigenvalue has
    multiplicity 4, well separated from the fifth. Each package's four
    zero vectors span the same space (judged as a subspace: any basis of
    it is right), and the fifth vectors agree in direction."""
    _, jg = graph_rows
    jlap = jconv.coo_to_csr(jlin.laplacian(jg, normalized))
    tlap = tconv.coo_to_csr(tlin.laplacian(to_t(jg), normalized))
    jv, jvec = jsol.lanczos_smallest(jlap, 5, max_iters=120)
    tv, tvec = tsol.lanczos_smallest(tlap, 5, max_iters=120)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    jvec, tvec = np.asarray(jvec), tvec.numpy()
    jq = np.linalg.qr(jvec[:, :4])[0]
    proj = np.linalg.norm(jq.T @ tvec[:, :4], axis=0)
    assert (proj >= 0.999).all(), proj
    assert abs(float(jvec[:, 4] @ tvec[:, 4])) >= 0.999


def test_lanczos_on_a_callable_matches_jax():
    rng = np.random.default_rng(9)
    q = np.linalg.qr(rng.standard_normal((40, 40)))[0]
    evals = np.concatenate([[0.1, 0.5, 1.0], np.linspace(3, 9, 37)])
    A = (q * evals) @ q.T
    A = ((A + A.T) / 2).astype(np.float32)
    At = torch.from_numpy(A)
    jv, jvec = jsol.lanczos_smallest(lambda v: A @ v, 3, n=40, max_iters=40)
    tv, tvec = tsol.lanczos_smallest(lambda v: At @ v, 3, n=40, max_iters=40,
                                     device=CPU)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    cos = np.abs(np.sum(np.asarray(jvec) * tvec.numpy(), axis=0))
    assert (cos >= 0.999).all(), cos
    with pytest.raises(ValueError, match="n is required"):
        tsol.lanczos_smallest(lambda v: v, 2)
