"""Port parity: raft_tpu_torch.neighbors.batch_knn against
raft_tpu.neighbors.batch_knn on the same numpy rows.

Both scans (device-chunked and out-of-core) run every metric with a short
final chunk; values agree at rtol 1e-5 plus an absolute 2e-6 of the
largest squared norm (the expanded L2 form cancels the norms), ids equal
but at near-ties. ``BatchKQuery``'s slabs equal the JAX package's and,
end to end, one brute-force search at the slabs' total k. An armed
``batch_knn.search_device_chunked=oom:1`` fault halves the chunk in both
packages, gives the unfaulted result and counts one
``resilience.degraded_tile``.
"""

import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu import resilience as jres
from raft_tpu.neighbors import batch_knn as jbk
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import resilience as tres
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import batch_knn as tbk
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.stats import metrics as tmet

torch.set_num_threads(2)
CPU = "cpu"
METRICS = ("sqeuclidean", "euclidean", "inner_product", "cosine")


@pytest.fixture(autouse=True)
def _clean_state():
    for r in (jres, tres):
        r.clear_faults()
    yield
    for r in (jres, tres):
        r.clear_faults()
    for ob in (jobs, tobs):
        ob.disable()
        ob.reset()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    centers = rng.standard_normal((20, 16)) * 3
    x = (centers[rng.integers(0, 20, 1000)]
         + rng.standard_normal((1000, 16))).astype(np.float32)
    q = (centers[rng.integers(0, 20, 60)]
         + rng.standard_normal((60, 16))).astype(np.float32)
    return x, q


def assert_agree(jv, ji, tv, ti, x, q, metric):
    """Per-row agreement; inner product ranks descending, so its values are
    compared negated (the checker reads ascending rows)."""
    jv, ji = torch.from_numpy(np.array(jv)), torch.from_numpy(np.array(ji))
    sign = -1.0 if metric == "inner_product" else 1.0
    scale = float(max((x.astype(np.float64) ** 2).sum(1).max(),
                      (q.astype(np.float64) ** 2).sum(1).max()))
    atol = 2e-6 * scale if metric in ("sqeuclidean", "inner_product") \
        else 1e-5
    verdict = tmet.topk_agreement(sign * jv, ji, sign * tv, ti, rtol=1e-5,
                                  atol=atol, tie_rtol=1e-4)
    assert verdict["ok"] and verdict["compared"] > 0, verdict
    assert ti.dtype == torch.int32


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("chunk_rows", [300, 1000])
def test_device_chunked_matches_jax(data, metric, chunk_rows):
    x, q = data
    jv, ji = jbk.search_device_chunked(x, q, 10, chunk_rows=chunk_rows,
                                       metric=metric)
    tv, ti = tbk.search_device_chunked(x, q, 10, chunk_rows=chunk_rows,
                                       metric=metric, device=CPU)
    assert_agree(jv, ji, tv, ti, x, q, metric)


@pytest.mark.parametrize("metric", METRICS)
def test_out_of_core_matches_jax(data, metric):
    x, q = data
    jv, ji = jbk.search_out_of_core(x, q, 10, metric=metric, chunk_rows=300)
    tv, ti = tbk.search_out_of_core(x, q, 10, metric=metric, chunk_rows=300,
                                    device=CPU)
    assert_agree(jv, ji, tv, ti, x, q, metric)
    # the workspace-sized chunks and a memmap-like host array agree too
    small = Resources(device=CPU, workspace_bytes=(16 + 60) * 4 * 128)
    tv2, ti2 = tbk.search_out_of_core(x, q, 10, metric=metric, res=small)
    assert torch.equal(ti2, ti)
    torch.testing.assert_close(tv2, tv, rtol=1e-6, atol=1e-5)


def test_out_of_core_short_final_chunk_pads(data):
    """A last chunk shorter than k pads with +inf before the merge."""
    x, q = data
    jv, ji = jbk.search_out_of_core(x[:250], q, 10, chunk_rows=248)
    tv, ti = tbk.search_out_of_core(x[:250], q, 10, chunk_rows=248,
                                    device=CPU)
    assert_agree(jv, ji, tv, ti, x, q, "sqeuclidean")


def test_device_chunked_equals_brute_force(data):
    x, q = data
    bv, bi = tbf.search(tbf.build(x, device=CPU), q, 10, device=CPU)
    tv, ti = tbk.search_device_chunked(x, q, 10, chunk_rows=128, device=CPU)
    assert_agree(bv.numpy(), bi.numpy(), tv, ti, x, q, "sqeuclidean")


def test_batch_k_query_slabs_match_jax(data):
    x, q = data
    jslabs = list(jbk.BatchKQuery(jbf.build(x[:100]), q[:8], 32))
    tslabs = list(tbk.BatchKQuery(tbf.build(x[:100], device=CPU), q[:8], 32,
                                  device=CPU))
    assert [s[0].shape for s in tslabs] == [(8, 32), (8, 32), (8, 32),
                                            (8, 4)]
    for (jv, ji), (tv, ti) in zip(jslabs, tslabs):
        assert_agree(jv, ji, tv, ti, x, q, "sqeuclidean")
    bv, bi = tbf.search(tbf.build(x[:100], device=CPU), q[:8], 96,
                        device=CPU)
    three = tslabs[:3]
    assert torch.equal(torch.cat([s[1] for s in three], 1), bi)
    assert torch.equal(torch.cat([s[0] for s in three], 1), bv)
    with pytest.raises(ValueError, match="batch_size"):
        tbk.BatchKQuery(tbf.build(x[:10], device=CPU), q, 0, device=CPU)


def test_oom_fault_halves_the_chunk_as_jax(data):
    x, q = data
    want_t = tbk.search_device_chunked(x, q, 10, chunk_rows=512, device=CPU)
    want_j = jbk.search_device_chunked(x, q, 10, chunk_rows=512)
    counts = []
    for res_mod, obs_mod, run in (
            (jres, jobs, lambda: jbk.search_device_chunked(
                x, q, 10, chunk_rows=512)),
            (tres, tobs, lambda: tbk.search_device_chunked(
                x, q, 10, chunk_rows=512, device=CPU))):
        obs_mod.enable()
        res_mod.clear_events()
        res_mod.arm_faults("batch_knn.search_device_chunked=oom:1")
        out = run()
        counts.append((obs_mod.snapshot()["counters"].get(
            "resilience.degraded_tile"), [
                (e["from_size"], e["to_size"]) for e in res_mod.recent_events()
                if e["event"] == "degraded_tile"]))
        if res_mod is tres:
            assert torch.equal(out[1], want_t[1])
            assert torch.equal(out[0], want_t[0])
        else:
            np.testing.assert_array_equal(np.asarray(out[1]),
                                          np.asarray(want_j[1]))
    assert counts[0] == counts[1] == (1, [(512, 256)])


def test_rejects_what_jax_rejects(data):
    x, q = data
    with pytest.raises(ValueError, match="supported metrics"):
        tbk.search_device_chunked(x, q, 5, metric="l1", device=CPU)
    with pytest.raises(ValueError, match="supported metrics"):
        tbk.search_out_of_core(x, q, 5, metric="l1", device=CPU)
    with pytest.raises(ValueError, match="queries must be"):
        tbk.search_out_of_core(x, q[:, :4], 5, device=CPU)
    with pytest.raises(ValueError, match="out of range"):
        tbk.search_out_of_core(x[:4], q, 5, device=CPU)
