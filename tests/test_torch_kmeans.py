"""Port parity: raft_tpu_torch.cluster.kmeans (Lloyd k-means) against
raft_tpu.cluster.kmeans on the same numpy blobs.

With ``init="array"`` both packages start from the same centroids and run
the same EM in fp32, so centroids agree at rtol 1e-4 and ``n_iter`` is
equal — unweighted, with ``sample_weight`` and under ``metric="euclidean"``
(whose inertia is the sum of distances). k-means++ draws from different
random streams (``torch.Generator`` against ``jax.random``), so it is
judged by inertia within 2% of the JAX fit's on well-separated blobs.
predict, transform, cluster_cost and fit_predict are held on the same
centroids; the hooks (deadline, interrupt, faultpoint, counters) are the
JAX package's.
"""

import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu.cluster import kmeans as jkm
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import resilience as tres
from raft_tpu_torch.cluster import kmeans as tkm
from raft_tpu_torch.core import interruptible as tint

torch.set_num_threads(2)
CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_state():
    tres.clear_faults()
    tobs.clear_spans()     # a span another file's test left in the ring
    yield
    tres.clear_faults()
    for ob in (jobs, tobs):
        ob.disable()
        ob.reset()


def blobs(seed, n=4000, dim=8, k=6, spread=6.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, dim)) * spread
    labels = rng.integers(0, k, n)
    x = centers[labels] + rng.standard_normal((n, dim))
    return x.astype(np.float32), rng


def start(x, rng, k):
    return x[rng.choice(x.shape[0], k, replace=False)].copy()


@pytest.mark.parametrize("seed,k,weighted,metric", [
    (0, 6, False, "sqeuclidean"), (1, 6, True, "sqeuclidean"),
    (2, 10, False, "euclidean"), (3, 4, True, "euclidean"),
    (4, 16, False, "sqeuclidean")])
def test_array_init_matches_jax(seed, k, weighted, metric):
    x, rng = blobs(seed)
    c0 = start(x, rng, k)
    w = rng.uniform(0.5, 2.0, x.shape[0]).astype(np.float32) \
        if weighted else None
    jout = jkm.fit(x, jkm.KMeansParams(n_clusters=k, init="array",
                                       metric=metric), sample_weight=w,
                   centroids=c0)
    tout = tkm.fit(x, tkm.KMeansParams(n_clusters=k, init="array",
                                       metric=metric), sample_weight=w,
                   centroids=c0, device=CPU)
    assert tout.n_iter == int(jout.n_iter)
    np.testing.assert_allclose(tout.centroids.numpy(),
                               np.asarray(jout.centroids), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(tout.inertia), float(jout.inertia),
                               rtol=1e-4)


@pytest.mark.parametrize("seed,k,n_init", [(0, 6, 1), (5, 12, 2)])
def test_plus_plus_inertia_within_two_percent(seed, k, n_init):
    # well-separated blobs: k-means++ finds every blob whatever its random
    # stream, so both packages reach the same optimum (on overlapping
    # blobs a single seeded start of either may stop in a local one)
    x, _ = blobs(seed, n=6000, k=k, spread=30.0)
    jout = jkm.fit(x, jkm.KMeansParams(n_clusters=k, n_init=n_init))
    tout = tkm.fit(x, tkm.KMeansParams(n_clusters=k, n_init=n_init),
                   device=CPU)
    assert abs(float(tout.inertia) - float(jout.inertia)) \
        <= 0.02 * float(jout.inertia)
    again = tkm.fit(x, tkm.KMeansParams(n_clusters=k, n_init=n_init),
                    device=CPU)
    torch.testing.assert_close(again.centroids, tout.centroids, rtol=0,
                               atol=0)


def test_plus_plus_seeds_on_the_capped_subsample():
    """More rows than max(4·k, 16384): the seeding sweeps a subsample,
    each centre is a data row, and the fit still lands at the JAX fit's
    inertia."""
    x, _ = blobs(7, n=20000, dim=4, k=5)
    gen = torch.Generator()
    gen.manual_seed(0)
    c = tkm._init_plus_plus(gen, torch.from_numpy(x), torch.ones(20000), 5)
    rows = {tuple(r) for r in x.tolist()}
    assert all(tuple(r) in rows for r in c.tolist())
    jout = jkm.fit(x, jkm.KMeansParams(n_clusters=5))
    tout = tkm.fit(x, tkm.KMeansParams(n_clusters=5), device=CPU)
    assert abs(float(tout.inertia) - float(jout.inertia)) \
        <= 0.02 * float(jout.inertia)


def test_random_init_and_max_iter():
    x, _ = blobs(8)
    tout = tkm.fit(x, tkm.KMeansParams(n_clusters=6, init="random",
                                       max_iter=2), device=CPU)
    assert tout.n_iter <= 2 and tout.centroids.shape == (6, 8)


def test_predict_transform_cost_fit_predict_match_jax():
    x, rng = blobs(9)
    c0 = start(x, rng, 6)
    w = rng.uniform(0.5, 2.0, x.shape[0]).astype(np.float32)
    jl, ji = jkm.predict(x, c0, sample_weight=w)
    tl, ti = tkm.predict(x, c0, sample_weight=w, device=CPU)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)
    np.testing.assert_allclose(tkm.transform(x, c0, device=CPU).numpy(),
                               np.asarray(jkm.transform(x, c0)),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(float(tkm.cluster_cost(x, c0, device=CPU)),
                               float(jkm.cluster_cost(x, c0)), rtol=1e-5)
    p = dict(n_clusters=6, init="array")
    jlab, jout = jkm.fit_predict(x, jkm.KMeansParams(**p), centroids=c0)
    tlab, tout = tkm.fit_predict(x, tkm.KMeansParams(**p), centroids=c0,
                                 device=CPU)
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
    assert tout.n_iter == int(jout.n_iter)


def test_empty_cluster_keeps_its_centre():
    x = np.array([[0.0, 0.0], [0.1, 0.0], [10.0, 10.0], [10.1, 10.0]],
                 np.float32)
    c0 = np.array([[0.0, 0.0], [10.0, 10.0], [500.0, 500.0]], np.float32)
    for pkg, kw in ((tkm, {"device": CPU}), (jkm, {})):
        out = pkg.fit(x, pkg.KMeansParams(n_clusters=3, init="array"),
                      centroids=c0, **kw)
        np.testing.assert_allclose(np.asarray(out.centroids)[2], c0[2])


def test_bad_params_raise_like_jax():
    for pkg in (tkm, jkm):
        with pytest.raises(ValueError):
            pkg.KMeansParams(init="bogus")
        with pytest.raises(ValueError):
            pkg.KMeansParams(metric="cosine")
    with pytest.raises(ValueError):
        tkm.fit(np.zeros((3, 2), np.float32), tkm.KMeansParams(n_clusters=4),
                device=CPU)
    with pytest.raises(ValueError):
        tkm.fit(np.zeros((9, 2), np.float32),
                tkm.KMeansParams(n_clusters=2, init="array"), device=CPU)


def test_spent_soft_deadline_keeps_the_first_fit():
    x, _ = blobs(10)
    p = tkm.KMeansParams(n_clusters=6, n_init=3)
    with tres.Deadline(0.0, hard=False) as dl:
        out = tkm.fit(x, p, device=CPU)
    assert dl.degraded and dl.degraded_sites == ["kmeans.fit"]
    one = tkm.fit(x, tkm.KMeansParams(n_clusters=6, n_init=1), device=CPU)
    torch.testing.assert_close(out.centroids, one.centroids, rtol=0, atol=0)
    with pytest.raises(tres.DeadlineExceeded):
        with tres.Deadline(0.0):
            tkm.fit(x, p, device=CPU)


def test_interrupt_and_faultpoint_surface_classified():
    x, _ = blobs(11)
    tint.cancel()
    with pytest.raises(tint.InterruptedException):
        tkm.fit(x, tkm.KMeansParams(n_clusters=6), device=CPU)
    tres.arm_faults("kmeans.fit.em=oom:1")
    with pytest.raises(tres.FaultInjected) as ei:
        tkm.fit(x, tkm.KMeansParams(n_clusters=6), device=CPU)
    assert tres.classify(ei.value) == tres.OOM
    assert tkm.fit(x, tkm.KMeansParams(n_clusters=6), device=CPU).n_iter >= 1


def test_counters_and_span_match_jax():
    x, rng = blobs(12)
    c0 = start(x, rng, 6)
    for ob in (jobs, tobs):
        ob.enable()
    jout = jkm.fit(x, jkm.KMeansParams(n_clusters=6, init="array"),
                   centroids=c0)
    tkm.fit(x, tkm.KMeansParams(n_clusters=6, init="array"), centroids=c0,
            device=CPU)
    jc = jobs.snapshot()["counters"]
    tc = tobs.snapshot()["counters"]
    keys = ("kmeans.fits", "kmeans.rows", "kmeans.iterations")
    assert {k: tc[k] for k in keys} == {k: jc[k] for k in keys}
    assert tc["kmeans.iterations"] == int(jout.n_iter)
    assert [s["name"] for s in tobs.spans()] == ["kmeans::fit"]
