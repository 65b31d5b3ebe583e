"""The port's telemetry in the IVF-PQ ragged search on an NVIDIA card:
K1's rows a block as its own launch plan reports them, the device half of
the per-name totals after the ring evicts, the work counters on the card,
and no synchronize added by telemetry. The tests carry the ``cuda``
marker and skip without a card. This file imports neither JAX nor the JAX
package: ``python -m pytest --noconftest -p no:cacheprovider -q
tests/test_torch_obs_search_card.py``."""

import warnings

import pytest
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.neighbors import ivf_pq
from raft_tpu_torch.obs import tracing
from raft_tpu_torch.obs.registry import settle
from raft_tpu_torch.ops import strip_scan as ss

pytestmark = pytest.mark.cuda

PHASES = ("ivf_pq::probe_select", "ivf_pq::bias", "strip_scan::plan",
          "strip_scan::group", "strip_scan::class", "strip_scan::merge",
          "ivf_pq::finalize", "ivf_pq::search", "ivf_pq::scan")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for fn in (obs.disable, obs.reset, obs.clear_spans):
        fn()
    yield torch.device("cuda", 0)
    for fn in (obs.disable, obs.reset, obs.clear_spans):
        fn()
    tracing.set_ring_cap(4096)


@pytest.mark.parametrize("dim,kf,n_sub,tour,rows", [
    (128, 20, 1, False, 32), (96, 20, 4, False, 32),
    (128, 512, 2, False, 32), (1024, 512, 2, False, 16),
    (1024, 20, 1, True, 32), (3072, 512, 2, False, 8)])
def test_k1_block_rows_come_from_its_launch_plan(card, dim, kf, n_sub, tour,
                                                 rows):
    """Shared memory a block: 32 rows fit up to dim 1024 at kf 20; a wide
    queue and carry (kf 512) at dim 1024 halve them once, at dim 3072
    twice."""
    assert ss.k1_block_rows(card, dim, 8192, 1024, n_sub, kf, tour) == rows


@pytest.fixture
def searched(card):
    g = torch.Generator(device=card).manual_seed(5)
    ds = torch.randn(60_000, 128, device=card, generator=g)
    qs = torch.randn(2_000, 128, device=card, generator=g)
    index = ivf_pq.build(ds, ivf_pq.IvfPqParams(
        n_lists=256, pq_dim=32, kmeans_n_iters=5), device=card)

    def search():
        return ivf_pq.search(index, qs, 20, n_probes=16, backend="ragged",
                             device=card)

    search()
    torch.cuda.synchronize()
    return search


def test_device_totals_stay_exact_when_the_ring_evicts(searched):
    tracing.set_ring_cap(5)
    obs.enable()
    for _ in range(3):
        searched()
    settle()
    timers = obs.snapshot()["timers"]
    assert len(obs.spans()) == 5 and tracing.pending_device() == 0
    for name in PHASES:
        t = timers[name]
        assert t["device_count"] == t["count"] >= 3, name
        assert t["device_total_s"] > 0
    outer = timers["ivf_pq::search"]["device_total_s"]
    inner = sum(timers[n]["device_total_s"] for n in PHASES[:7])
    assert inner <= outer * 1.01


def test_work_counters_on_the_card(searched):
    obs.enable()
    searched()
    settle()
    c = obs.snapshot()["counters"]
    assert c["strip_scan.k1.launches"] >= 1
    assert 0 < c["strip_scan.k1.products_needed"] <= \
        c["strip_scan.k1.products_computed"]
    assert c["strip_scan.slots.live"] == 2_000 * 16
    assert c["strip_scan.slots.live"] <= c["strip_scan.slots.launched"]


def count_syncs(fn) -> int:
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def test_telemetry_adds_no_synchronize_to_a_search(searched):
    off = count_syncs(searched)
    obs.enable()
    searched()
    on = count_syncs(searched)
    assert on == off
