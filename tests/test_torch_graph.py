"""Port parity: label, single linkage and spectral partition against the
JAX package on the same numpy inputs.

Labels are exact. Single linkage (pairwise and kNN connectivity, with and
without the cross-component repair) gives the same partition as the JAX
package's up to relabelling, and the same merge heights at rtol 1e-5 and
an absolute 2e-6 of the largest squared norm (the expanded distance's
cancellation). Spectral partition draws its Lanczos start vectors and
k-means seeds from torch's streams, so it is held to the JAX test's
two-block split (``tests/test_parity_tail.py:96``) with the same adjusted
Rand index 1.0; ``analyze_partition`` on one labelling equals JAX's at
rtol 1e-6.
"""

import numpy as np
import pytest
import torch
from sklearn.metrics import adjusted_rand_score

from raft_tpu import spectral as jspec
from raft_tpu.cluster import single_linkage as jsl
from raft_tpu.label import get_classes as jget, make_monotonic as jmono
from raft_tpu.label import merge_labels as jmerge
from raft_tpu.sparse import neighbors as jnb
from raft_tpu_torch import spectral as tspec
from raft_tpu_torch.cluster import single_linkage as tsl
from raft_tpu_torch.label import get_classes as tget, make_monotonic as tmono
from raft_tpu_torch.label import merge_labels as tmerge
from raft_tpu_torch.sparse import COO
from raft_tpu_torch.sparse import neighbors as tnb

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


LABEL_CASES = [np.array([5, 3, 5, 9, 3, 0, 9], np.int32),
               np.array([-2, 7, 7, 7, 100, -2], np.int32),
               np.random.default_rng(0).integers(0, 50, 300).astype(np.int32),
               np.array([4], np.int32),
               # a real label at the int32 max: the JAX package's ignore
               # sentinel, merged into the largest other class there
               np.array([5, 2 ** 31 - 1, 7, 3, 7], np.int32),
               np.array([2 ** 31 - 1, 7, 7], np.int32)]


@pytest.mark.parametrize("case", range(len(LABEL_CASES)))
@pytest.mark.parametrize("ignore", [None, 7, 3])
def test_make_monotonic_equals_jax(case, ignore):
    lab = LABEL_CASES[case]
    jm, jn = jmono(lab, ignore_value=ignore)
    tm, tn = tmono(lab, ignore_value=ignore, device=CPU)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tm.dtype == torch.int32 and int(tn) == int(jn)


@pytest.mark.parametrize("case", range(len(LABEL_CASES)))
def test_get_classes_equals_jax(case):
    lab = LABEL_CASES[case]
    jc, jn = jget(lab)
    tc, tn = tget(lab, device=CPU)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tn) == int(jn)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_labels_equals_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 40, 200).astype(np.int32)
    b = rng.integers(0, 60, 200).astype(np.int32)
    np.testing.assert_array_equal(tmerge(a, b, device=CPU).numpy(),
                                  np.asarray(jmerge(a, b)))


def test_empty_labels_give_no_class():
    """An empty int32 array: the port returns 0 classes and empty results
    (with and without ``ignore_value``, and from ``get_classes``). The JAX
    package returns n_unique 1 from ``make_monotonic`` (its ``is_new``
    pad), raises ``IndexError`` with ``ignore_value`` and ``TypeError``
    from ``get_classes`` (ROADMAP Queue 3, in the reference only)."""
    empty = np.zeros(0, np.int32)
    for ignore in (None, 1):
        mono, n = tmono(empty, ignore_value=ignore, device=CPU)
        assert mono.dtype == torch.int32 and mono.numel() == 0
        assert int(n) == 0
    classes, n = tget(empty, device=CPU)
    assert classes.numel() == 0 and int(n) == 0
    assert int(jmono(empty)[1]) == 1
    with pytest.raises(IndexError):
        jmono(empty, ignore_value=1)
    with pytest.raises(TypeError):
        jget(empty)


def test_labels_follow_the_device_rule():
    with pytest.raises(ValueError, match="1-D"):
        tmono(np.zeros((2, 2), np.int32), device=CPU)
    with pytest.raises(ValueError, match="equal-length"):
        tmerge([0, 1], [0, 1, 2], device=CPU)
    t = torch.tensor([3, 1, 3])
    assert tmono(t)[0].device == t.device


def blobs(seed, n, k, dim=4, spread=12.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, dim)) * spread
    lab = rng.integers(0, k, n)
    return (centers[lab] + rng.standard_normal((n, dim))).astype(np.float32)


def same_partition(a, b):
    return adjusted_rand_score(np.asarray(a), np.asarray(b)) == 1.0


def assert_heights_close(got, want, X):
    """Merge heights are expanded squared distances: ‖x‖² + ‖y‖² − 2⟨x, y⟩
    cancels norms far above the heights, so the packages' fp32 products
    differ by a few ulps of the largest norm."""
    scale = float((X.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6 * scale)


@pytest.mark.parametrize("n_clusters", [1, 3, 5])
def test_single_linkage_pairwise_equals_jax(n_clusters):
    X = blobs(1, 120, 5)
    j = jsl.single_linkage(X, n_clusters, connectivity="pairwise")
    t = tsl.single_linkage(X, n_clusters, connectivity="pairwise", device=CPU)
    assert same_partition(j.labels, t.labels)
    assert len(np.unique(t.labels.numpy())) == n_clusters
    assert_heights_close(t.mst_heights.numpy(), np.asarray(j.mst_heights), X)
    assert_heights_close(t.to_scipy_linkage()[:, 2],
                         j.to_scipy_linkage()[:, 2], X)


@pytest.mark.parametrize("c,metric", [(15, "sqeuclidean"), (15, "euclidean"),
                                      (-4, "sqeuclidean")])
def test_single_linkage_knn_equals_jax(c, metric):
    """c = -4 gives k = 3 on four far-apart blobs: the kNN graph is a
    forest, and the cross-component repair joins it."""
    X = blobs(2, 200, 4, spread=40.0)
    j = jsl.single_linkage(X, 4, metric=metric, c=c)
    t = tsl.single_linkage(X, 4, metric=metric, c=c, device=CPU)
    assert same_partition(j.labels, t.labels)
    assert len(np.unique(t.labels.numpy())) == 4
    assert_heights_close(np.sort(t.mst_heights.numpy()),
                         np.sort(np.asarray(j.mst_heights)), X)
    if c < 0:   # the repair ran: the kNN graph alone was a forest
        g = tnb.knn_graph(X, 3, device=CPU)
        from raft_tpu_torch.sparse.solver import mst
        assert int(mst(g).n_edges) < X.shape[0] - 1


def test_single_linkage_repair_tiles_its_distance_blocks():
    """A workspace holding a few rows of the (n, n) block at a time gives
    the same repair edges as one block."""
    from raft_tpu_torch.core.resources import Resources

    X = torch.from_numpy(blobs(3, 90, 3, spread=40.0))
    color = torch.from_numpy(np.repeat(np.arange(3, dtype=np.int32), 30))
    color = color[torch.randperm(90, generator=torch.Generator().manual_seed(0))]
    whole = tsl._cross_component_edges(X, color, "sqeuclidean",
                                       Resources(device=CPU))
    tiled = tsl._cross_component_edges(X, color, "sqeuclidean",
                                       Resources(device=CPU,
                                                 workspace_bytes=4096))
    for a, b in ((whole.rows, tiled.rows), (whole.cols, tiled.cols),
                 (whole.vals, tiled.vals)):
        assert torch.equal(a, b)


def test_single_linkage_rejects_what_jax_rejects():
    X = blobs(4, 20, 2)
    with pytest.raises(ValueError, match="n_clusters"):
        tsl.single_linkage(X, 0, device=CPU)
    with pytest.raises(ValueError, match="connectivity"):
        tsl.single_linkage(X, 2, connectivity="full", device=CPU)
    forest = tsl.LinkageResult(torch.zeros(3, dtype=torch.int32),
                               torch.tensor([0, -1], dtype=torch.int32),
                               torch.tensor([1, -1], dtype=torch.int32),
                               torch.tensor([1.0, float("inf")]), 2)
    with pytest.raises(ValueError, match="forest"):
        forest.to_scipy_linkage()


def two_blocks(seed=11, n=60):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.standard_normal((n // 2, 4)).astype(np.float32) * 0.3,
        rng.standard_normal((n // 2, 4)).astype(np.float32) * 0.3 + 8.0,
    ])


@pytest.mark.parametrize("seed", [1, 2])
def test_spectral_partition_splits_two_blocks_as_jax(seed):
    X = two_blocks()
    jg = jnb.knn_graph(X, k=6)
    tg = tnb.knn_graph(X, k=6, device=CPU)
    jl, jv, _ = jspec.partition(jg, 2, seed=seed)
    tl, tv, tvec = tspec.partition(tg, 2, seed=seed, device=CPU)
    want = np.repeat([0, 1], 30)
    assert adjusted_rand_score(want, np.asarray(jl)) == 1.0
    assert adjusted_rand_score(want, tl.numpy()) == 1.0
    assert abs(float(tv[0])) < 1e-2 and tvec.shape == (60, 2)
    cut, _ = tspec.analyze_partition(tg, tl)
    total_w = float(tg.vals.sum()) / 2
    assert 0 <= float(cut) < total_w / 4


def test_analyze_partition_equals_jax():
    X = two_blocks()
    jg = jnb.knn_graph(X, k=6)
    tg = COO(*[torch.from_numpy(np.array(a))
               for a in (jg.rows, jg.cols, jg.vals)], shape=jg.shape)
    labels = (np.arange(60) % 3).astype(np.int32)
    jc, jcost = jspec.analyze_partition(jg, labels)
    tc, tcost = tspec.analyze_partition(tg, torch.from_numpy(labels))
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-6)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-6)


def test_fit_embedding_eigenvalues_match_jax():
    X = two_blocks()
    jg = jnb.knn_graph(X, k=6)
    tg = COO(*[torch.from_numpy(np.array(a))
               for a in (jg.rows, jg.cols, jg.vals)], shape=jg.shape)
    jv, _ = jspec.fit_embedding(jg, 3, max_iters=60)
    tv, _ = tspec.fit_embedding(tg, 3, max_iters=60)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    with pytest.raises(ValueError, match="n_components"):
        tspec.fit_embedding(tg, 0)
