"""K1 reading its query rows by id on an NVIDIA card: against K1 on the
grouped operand, bit for bit, on both product loops; K2 on its grouped
operand against its twin; the IVF-PQ ragged search against the same search
with a grouped operand; no synchronize in a warm search; every K1 launch of
a traced search by id. K1's gathered walk under a filter passing a tenth
of the rows: against its twin and, bit for bit on every finite slot,
against the dense walk with exact selection, on both product loops; a
traced filtered search against the same search on the dense exact walk,
every K1 launch gathered. The tests carry the ``cuda`` marker and skip
without a card. This file imports neither JAX nor the JAX package:
``python -m pytest --noconftest -p no:cacheprovider -q
tests/test_torch_strip_scan_card.py``."""

import warnings

import pytest
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.neighbors import ivf_pq
from raft_tpu_torch.obs.registry import settle
from raft_tpu_torch.ops import bq_scan as bq
from raft_tpu_torch.ops import strip_scan as ss
from raft_tpu_torch.stats.metrics import topk_agreement

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K1 is CUDA code with no CPU mode")
    for fn in (obs.disable, obs.reset, obs.clear_spans):
        fn()
    yield torch.device("cuda", 0)
    for fn in (obs.disable, obs.reset, obs.clear_spans):
        fn()


def planned_tile(dev, dim, b_dtype, n_sub, q=3000, p=8, seed=0):
    """One query tile on the card, planned on the static layout as the
    search plans it: several length classes (one of ``n_sub`` sub-blocks),
    padding strips, full and partial strips."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n_lists = 64
    m = 4096 * n_sub
    lens = torch.randint(100, m + 1, (n_lists,), generator=g, device=dev)
    lens[:8] = torch.tensor([40, 600, 1100, 2100, 3000, m, m - 7, 511],
                            device=dev)
    if b_dtype == torch.int8:
        data = torch.randint(-127, 128, (n_lists, m, dim), generator=g,
                             device=dev, dtype=torch.int8)
    else:
        data = torch.randint(0, 256, (n_lists, m, dim), generator=g,
                             device=dev, dtype=torch.uint8)
    col = torch.arange(m, device=dev)[None, :]
    bias = torch.where(col < lens[:, None],
                       torch.rand((n_lists, m), generator=g, device=dev)
                       * 1000.0, float("inf"))
    queries = torch.randn((q, dim), generator=g, device=dev) * 4
    probes = torch.argsort(torch.rand((q, n_lists), generator=g, device=dev),
                           dim=1)[:, :p].to(torch.int32)
    classes, cls_ord = ss.class_info(lens.cpu().numpy(), dim=dim)
    starts, s_tot, layout = ss.static_layout(
        classes, ss.class_counts_of(cls_ord, len(classes)), q, p)
    qids, strip_list, _, _, _ = ss._plan_device(
        probes, torch.as_tensor(cls_ord, device=dev), n_lists, starts, s_tot)
    return queries, data, bias.contiguous(), qids, strip_list, layout


def real_rows(strip_list, strip_rows):
    slots = torch.arange(ss.C, device=strip_list.device)[None, :]
    return (strip_list >= 0)[:, None] & (slots < strip_rows[:, None])


@pytest.mark.parametrize("dim,b_dtype,n_sub,approx_ok", [
    (128, torch.uint8, 1, True), (128, torch.int8, 2, False),
    (96, torch.int8, 1, True), (96, torch.uint8, 2, False)])
def test_k1_by_id_equals_k1_on_the_grouped_operand(card, dim, b_dtype,
                                                   n_sub, approx_ok):
    """Dim 128 runs K1's wgmma loop, dim 96 its mma.sync loop: reading the
    rows by id gives the grouped operand's values and offsets bit for bit
    over every real row of every class, and counts as a launch by id."""
    queries, data, bias, qids, strip_list, layout = planned_tile(
        card, dim, b_dtype, n_sub)
    strip_rows = (qids >= 0).sum(dim=1, dtype=torch.int32)
    rows = queries.to(torch.bfloat16)
    assert len(layout) >= 2 and max(ns for (_, ns, _, _) in layout) == n_sub
    assert bool((strip_rows == ss.C).any()) and bool((strip_list < 0).any())
    for (w_blocks, ns, start, count) in layout:
        seg = slice(start, start + count)
        args = (data, bias, w_blocks, ns, -2.0, 20, approx_ok,
                strip_rows[seg])
        want = ss.strip_class(strip_list[seg],
                              ss.group_queries(queries, qids[seg]), *args)
        by_id0 = ss.STRIP_KERNEL_BY_ID.launches
        got = ss.strip_class(strip_list[seg], rows, *args, qids=qids[seg])
        torch.cuda.synchronize()
        assert ss.STRIP_KERNEL_BY_ID.launches == by_id0 + 1
        mask = real_rows(strip_list[seg], strip_rows[seg])
        assert bool(mask.any())
        assert torch.equal(got[0][mask], want[0][mask])
        assert torch.equal(got[1][mask], want[1][mask])


@pytest.mark.parametrize("nb,kf,loop", [(16, 80, "wgmma"),
                                        (5, 40, "mma.sync")])
def test_k2_on_its_grouped_operand_matches_its_twin(card, nb, kf, loop):
    """K2 shares K1's staging with no qids: its grouped operand still
    gives its twin's result on both loops."""
    g = torch.Generator(device=card).manual_seed(31)
    n_lists, m = 3, 2048
    lens = torch.tensor([700, 1500, 300], device=card)
    col = torch.arange(m, device=card)[None, :]
    live = col < lens[:, None]
    codes = torch.randint(0, 256, (n_lists, m, nb), generator=g, device=card,
                          dtype=torch.uint8)
    scale = torch.where(live, 0.5 + 1.5 * torch.rand(
        (n_lists, m), generator=g, device=card), 0.0).contiguous()
    bias = torch.where(live, torch.randn((n_lists, m), generator=g,
                                         device=card) * 8 * nb,
                       float("inf")).contiguous()
    sl = torch.tensor([0, -1, 1, 2, 1], dtype=torch.int32, device=card)
    a = torch.randn((5, ss.C, 8 * nb), generator=g, device=card).to(
        torch.bfloat16)
    got = bq.bq_class(sl, a, codes, scale, bias, 4, 1, -2.0, kf, False)
    assert bq.BQ_KERNEL.loop == loop
    want = bq._bq_class_plain(sl, a, codes, scale, bias, 4, 1, -2.0, kf,
                              False)
    verdict = topk_agreement(want[0], want[1], got[0], got[1], rtol=5e-4,
                             atol=1e-2, mask=sl >= 0)
    assert verdict["ok"], verdict


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


def test_search_by_id_returns_the_grouped_search(searched, monkeypatch):
    """The ragged IVF-PQ search with K1 reading rows by id returns the
    values and ids of the same search with K1 on a grouped operand."""
    got = searched()

    def grouped_k1(list_data, bias, alpha, kf, approx_ok, gathered=False):
        assert not gathered                      # no filter
        return ss.kernel_fn(
            lambda sl, a, w_blocks, n_sub, rows: ss.strip_class(
                sl, a, list_data, bias, w_blocks, n_sub, alpha, kf,
                approx_ok, rows),
            "K1", ss.K1Work(bias, kf, approx_ok))

    monkeypatch.setattr(ss, "_k1_class_fn", grouped_k1)
    want = searched()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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


def test_warm_search_makes_no_sync_with_telemetry_off_and_on(searched):
    assert count_syncs(searched) == 0
    obs.enable()
    searched()
    assert count_syncs(searched) == 0


def test_every_k1_launch_of_a_traced_search_reads_by_id(searched):
    obs.enable()
    searched()
    settle()
    c = obs.snapshot()["counters"]
    assert c["strip_scan.k1.launches"] >= 1
    assert c["strip_scan.k1.by_id_launches"] == c["strip_scan.k1.launches"]
    assert "strip_scan.k1.gathered_launches" not in c   # no filter


def filtered(bias, share, seed):
    """``bias`` as a filter passing a random ``share`` of the rows leaves
    it: the other lanes +inf."""
    g = torch.Generator(device=bias.device).manual_seed(seed)
    keep = torch.rand(bias.shape, generator=g, device=bias.device) < share
    return torch.where(keep, bias, float("inf")).contiguous()


@pytest.mark.parametrize("dim,b_dtype,n_sub", [
    (128, torch.int8, 1), (128, torch.uint8, 2), (96, torch.int8, 2),
    (96, torch.uint8, 1)])
def test_k1_gathered_walk_equals_its_twin_and_the_dense_exact_walk(
        card, dim, b_dtype, n_sub):
    """Dim 128 runs the gathered walk on wgmma, dim 96 on mma.sync: against
    its twin within the fp32 sums' order, and against K1's dense walk with
    exact selection bit for bit on every finite slot, with the same +inf
    pattern and +inf slots at offsets inside the list; each launch counts
    as gathered."""
    queries, data, bias, qids, strip_list, layout = planned_tile(
        card, dim, b_dtype, n_sub, q=1500)
    bias = filtered(bias, 0.1, dim + n_sub)
    strip_rows = (qids >= 0).sum(dim=1, dtype=torch.int32)
    rows = queries.to(torch.bfloat16)
    for (w_blocks, ns, start, count) in layout:
        seg = slice(start, start + count)
        args = (data, bias, w_blocks, ns, -2.0, 20, True, strip_rows[seg])
        before = ss.STRIP_KERNEL_GATHERED.launches
        got = ss.strip_class(strip_list[seg], rows, *args, qids=qids[seg],
                             gathered=True)
        torch.cuda.synchronize()
        assert ss.STRIP_KERNEL_GATHERED.launches == before + 1
        dense = ss.strip_class(strip_list[seg], rows, data, bias, w_blocks,
                               ns, -2.0, 20, False, strip_rows[seg],
                               qids=qids[seg])
        twin = ss._strip_class_plain(strip_list[seg], rows, *args,
                                     qids=qids[seg], gathered=True)
        mask = real_rows(strip_list[seg], strip_rows[seg])
        assert bool(mask.any())
        verdict = topk_agreement(twin[0], twin[1], got[0], got[1],
                                 rtol=5e-4, atol=1e-2, mask=mask)
        assert verdict["ok"], verdict
        fin = torch.isfinite(dense[0]) & mask[:, :, None]
        assert torch.equal(fin, torch.isfinite(got[0]) & mask[:, :, None])
        assert torch.equal(got[0][fin], dense[0][fin])
        assert torch.equal(got[1][fin], dense[1][fin])
        e = got[1][mask[:, :, None].expand_as(got[1])]
        assert int(e.min()) >= 0 and int(e.max()) < ns * w_blocks * ss.MC


@pytest.fixture
def filtered_search(card):
    from raft_tpu_torch.core.bitset import Bitset

    g = torch.Generator(device=card).manual_seed(6)
    ds = torch.randn(60_000, 128, device=card, generator=g)
    qs = torch.randn(2_000, 128, device=card, generator=g)
    index = ivf_pq.build(ds, ivf_pq.IvfPqParams(
        n_lists=256, pq_dim=32, kmeans_n_iters=5), device=card)
    keep = torch.rand(60_000, generator=g, device=card) < 0.1
    bitset = Bitset.from_mask(keep, device=card)

    def search():
        return ivf_pq.search(index, qs, 20, n_probes=16, backend="ragged",
                             filter=bitset, device=card)

    search()
    torch.cuda.synchronize()
    return search, keep


def test_traced_filtered_search_returns_the_exact_dense_walk(
        filtered_search, monkeypatch):
    """A traced IVF-PQ search under a 10% filter runs every K1 launch on
    the gathered walk and returns the values and ids of the same search on
    the dense walk with exact selection; no id fails the filter."""
    search, keep = filtered_search
    obs.enable()
    got = search()
    settle()
    c = obs.snapshot()["counters"]
    assert c["strip_scan.k1.launches"] >= 1
    assert c["strip_scan.k1.gathered_launches"] == c["strip_scan.k1.launches"]
    obs.disable()
    real = ss._k1_class_fn

    def dense_exact(list_data, bias, alpha, kf, approx_ok, gathered=False):
        return real(list_data, bias, alpha, kf, False, False)

    monkeypatch.setattr(ss, "_k1_class_fn", dense_exact)
    want = search()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ids = got[1][got[1] >= 0].long()
    assert bool(ids.numel()) and bool(keep[ids].all())

