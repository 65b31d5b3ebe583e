"""Port parity: raft_tpu_torch.ops.strip_scan (the plain twin of kernel K1
plus the host plan and merge) against raft_tpu.ops.strip_scan.strip_search
run in Pallas interpret mode, on the same numpy inputs.

Tolerances: candidate values allclose at rtol 5e-4 (fp32 sums in another
order can move a score across one 12-bit packing quantum, 2^-11 relative);
ids equal except where the two results hold candidates whose values tie
within 1e-3 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import strip_scan as jss
from raft_tpu_torch.ops import strip_scan as tss
from raft_tpu_torch.stats.metrics import topk_agreement

torch.set_num_threads(2)


def make_lists(rng, n_lists, dim, lens, int8=False):
    chunks = max((int(max(lens)) + 511) // 512, 1)
    m = 512 * (1 << (chunks - 1).bit_length())
    data = np.zeros((n_lists, m, dim), np.float32)
    bias = np.full((n_lists, m), np.inf, np.float32)
    ids = np.full((n_lists, m), -1, np.int32)
    nxt = 0
    for l in range(n_lists):
        v = rng.standard_normal((lens[l], dim)).astype(np.float32)
        if int8:
            v = np.clip(np.round(v * 40), -127, 127)
        data[l, :lens[l]] = v
        bias[l, :lens[l]] = (v ** 2).sum(1)
        ids[l, :lens[l]] = np.arange(nxt, nxt + lens[l])
        nxt += lens[l]
    if int8:
        data = data.astype(np.int8)
    return data, bias, ids


def run_both(queries, probes, data, bias, ids, lens, k, approx_ok):
    jv, ji = jss.strip_search(queries, probes, jnp.asarray(data),
                              jnp.asarray(bias), jnp.asarray(ids), lens, k,
                              alpha=-2.0, interpret=True, approx_ok=approx_ok)
    tv, ti = tss.strip_search(torch.from_numpy(queries),
                              torch.from_numpy(probes), torch.from_numpy(data),
                              torch.from_numpy(bias), torch.from_numpy(ids),
                              lens, k, alpha=-2.0, approx_ok=approx_ok)
    return (torch.from_numpy(np.asarray(jv)), torch.from_numpy(np.asarray(ji)),
            tv, ti)


def assert_agree(jv, ji, tv, ti):
    verdict = topk_agreement(jv, ji, tv, ti, rtol=5e-4, tie_rtol=1e-3)
    assert verdict["ok"], verdict
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32


CASES = {
    # skewed lengths with an empty list every query probes
    "skewed_empty": dict(n_lists=7, dim=16, q=40, p=3, lens=[0, 900, 30, 1400,
                                                             5, 300, 1100]),
    # many lists, two length classes: padded class counts below the region
    # size exercise merge_strip_candidates' per-class strip remap
    "multi_class_remap": dict(n_lists=120, dim=8, q=150, p=4,
                              lens=[100, 900] * 60),
    # one list longer than one fetch: n_sub = 2 sub-blocks
    "n_sub": dict(n_lists=3, dim=8, q=31, p=2, lens=[6000, 40, 700]),
}


@pytest.mark.parametrize("kf", [10, 20, 40])
@pytest.mark.parametrize("case", sorted(CASES))
def test_strip_search_matches_jax(case, kf):
    c = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) * 100 + kf)
    lens = np.asarray(c["lens"])
    data, bias, ids = make_lists(rng, c["n_lists"], c["dim"], lens)
    queries = rng.standard_normal((c["q"], c["dim"])).astype(np.float32)
    probes = np.stack([rng.choice(c["n_lists"], c["p"], replace=False)
                       for _ in range(c["q"])]).astype(np.int32)
    if case == "skewed_empty":
        probes[:, 0] = 0
    out = run_both(queries, probes, data, bias, ids, lens, kf, approx_ok=True)
    assert_agree(*out)


@pytest.mark.parametrize("int8", [False, True])
def test_dead_sub_blocks_and_lists_match_jax(int8):
    rng = np.random.default_rng(11)
    lens = np.array([6000, 800, 1500, 700])
    data, bias, ids = make_lists(rng, 4, 16, lens, int8=int8)
    bias[0, 4096:] = np.inf        # a dead later sub-block
    bias[3] = np.inf               # a fully dead list
    queries = rng.standard_normal((50, 16)).astype(np.float32)
    if int8:
        queries = queries * 0.05
    probes = np.stack([rng.choice(4, 3, replace=False)
                       for _ in range(50)]).astype(np.int32)
    out = run_both(queries, probes, data, bias, ids, lens, 20, approx_ok=True)
    assert_agree(*out)


def _class_inputs(rng, w_blocks, n_sub, kf, n_lists=5, s_real=6, s_pad=9,
                  dim=16, int8=True):
    w = 512 * w_blocks
    m = w * n_sub
    if int8:
        b = rng.integers(-127, 128, (n_lists, m, dim)).astype(np.int8)
    else:
        b = (rng.standard_normal((n_lists, m, dim)) * 8).astype(np.float32)
    lens = rng.integers(kf, m + 1, n_lists)
    bias = np.where(np.arange(m)[None] < lens[:, None],
                    rng.random((n_lists, m)) * 500, np.inf).astype(np.float32)
    bias[0] = np.inf                                   # dead list
    if n_sub > 1:
        bias[1, :w] = np.inf                           # dead first sub-block
    u = rng.random((n_lists, m))
    bias[u < 0.01] = np.nan
    bias[(u >= 0.01) & (u < 0.02)] = -np.inf
    sl = rng.integers(0, n_lists, s_pad).astype(np.int32)
    sl[rng.permutation(s_pad)[:s_pad - s_real]] = -1   # padding strips
    a = (rng.standard_normal((s_pad, tss.C, dim)) * 2).astype(np.float32)
    return sl, a, b, bias


@pytest.mark.parametrize("w_blocks,n_sub,kf,int8", [
    (2, 1, 20, True), (1, 3, 40, True), (2, 2, 20, False), (1, 1, 10, False)])
def test_class_plain_twin_matches_pallas_kernel(w_blocks, n_sub, kf, int8):
    """The per-class function itself: padding strips, dead sub-blocks and
    lists, ±inf/NaN bias lanes, int8 and fp32 lists."""
    rng = np.random.default_rng(w_blocks * 100 + n_sub * 10 + kf)
    sl, a, b, bias = _class_inputs(rng, w_blocks, n_sub, kf, int8=int8)
    jv, je = jss._strip_class_call(
        jnp.asarray(sl), jnp.asarray(a, jnp.bfloat16), jnp.asarray(b),
        jnp.asarray(bias)[:, None, :], w_blocks, n_sub, -2.0, kf, True, True)
    tv, te = tss.strip_class(
        torch.from_numpy(sl), torch.from_numpy(a).to(torch.bfloat16),
        torch.from_numpy(b), torch.from_numpy(bias), w_blocks, n_sub, -2.0,
        kf, approx_ok=True)
    live = torch.from_numpy(sl) >= 0
    verdict = topk_agreement(torch.from_numpy(np.asarray(jv)),
                             torch.from_numpy(np.asarray(je)), tv, te,
                             rtol=5e-4, tie_rtol=1e-3, mask=live)
    assert verdict["ok"], verdict
    assert verdict["compared"] > 0


def test_tournament_rule_matches_jax():
    for kf in (8, 16, 20, 32, 40):
        for w in (256, 512, 1024, 4096):
            bs = w // 128
            wins = kf * w > 4 * w + kf * 4 * 128
            want = not (kf < 16 or kf > min(bs * 4, 32) or bs < 2 or not wins)
            assert tss.tournament_engaged(kf, w, True) == want
            assert not tss.tournament_engaged(kf, w, False)


def test_plan_helpers_match_jax():
    rng = np.random.default_rng(3)
    lens = rng.integers(0, 5000, 64)
    jc, jo = jss.class_info(lens, dim=128)
    tc, to = tss.class_info(lens, dim=128)
    assert jc == tc and np.array_equal(jo, to)
    counts = tss.class_counts_of(to, len(tc))
    assert counts == jss.class_counts_of(jo, len(jc))
    assert tss.static_layout(tc, counts, 300, 8) == jss.static_layout(
        jc, counts, 300, 8)
    assert tss.fit_q_tile(10_000, 16, 64, len(tc), 40, 1 << 24, 128, counts) \
        == jss.fit_q_tile(10_000, 16, 64, len(jc), 40, 1 << 24, 128, counts)
    for n in (1, 8, 9, 13, 100, 1000):
        assert tss._bucket(n) == jss._bucket(n)


def test_plan_device_matches_jax():
    rng = np.random.default_rng(9)
    n_lists, q, p = 50, 300, 5
    lens = rng.integers(0, 3000, n_lists)
    classes, cls_ord = tss.class_info(lens, dim=32)
    counts = tss.class_counts_of(cls_ord, len(classes))
    starts, s_tot, _ = tss.static_layout(classes, counts, q, p)
    probes = np.stack([rng.choice(n_lists, p, replace=False)
                       for _ in range(q)]).astype(np.int32)
    want = jss._plan_device(jnp.asarray(probes), jnp.asarray(cls_ord), n_lists,
                            starts, s_tot)
    got = tss._plan_device(torch.from_numpy(probes), torch.from_numpy(cls_ord),
                           n_lists, starts, s_tot)
    for w_, g_ in zip(want, got):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


def _by_id_tile(rng, dim, b_dtype, n_sub, q=50, p=3):
    """One query tile planned as the search plans it (static layout):
    several length classes, padding strips and partial strips. Lists of
    int8 or uint8 rows; with ``n_sub`` 2 one list spans two sub-blocks.
    Returns the fp32 queries, the list operands, the plan's tables
    (qids, strip_list, pair_strip, pair_slot) and the layout."""
    lens = np.array([300, 900, 1500, 40, 700, 2000] if n_sub == 1
                    else [300, 900, 5000, 40, 2000, 6000])
    m = 8192 if n_sub == 2 else 2048
    n_lists = lens.size
    if b_dtype == "int8":
        data = rng.integers(-127, 128, (n_lists, m, dim)).astype(np.int8)
    else:
        data = rng.integers(0, 256, (n_lists, m, dim)).astype(np.uint8)
    bias = np.where(np.arange(m)[None] < lens[:, None],
                    rng.random((n_lists, m)) * 1000, np.inf).astype(np.float32)
    queries = (rng.standard_normal((q, dim)) * 4).astype(np.float32)
    probes = np.stack([rng.choice(n_lists, p, replace=False)
                       for _ in range(q)]).astype(np.int32)
    classes, cls_ord = tss.class_info(lens, dim=dim)
    starts, s_tot, layout = tss.static_layout(
        classes, tss.class_counts_of(cls_ord, len(classes)), q, p)
    plan = tss._plan_device(torch.from_numpy(probes),
                            torch.from_numpy(cls_ord), n_lists, starts, s_tot)
    return (torch.from_numpy(queries), torch.from_numpy(data),
            torch.from_numpy(bias), plan[:4], layout)


@pytest.mark.parametrize("n_sub", [1, 2])
@pytest.mark.parametrize("tournament", [False, True])
@pytest.mark.parametrize("b_dtype", ["int8", "uint8"])
@pytest.mark.parametrize("dim", [96, 128])
def test_twin_by_id_equals_twin_on_grouped_operand(dim, b_dtype, tournament,
                                                   n_sub):
    """K1's twin given the (q, dim) bf16 rows and the plan's qids returns
    the grouped call's values and offsets bit for bit, in every class of a
    tile: padding strips, partial strips, one and two sub-blocks, with and
    without the tournament."""
    rng = np.random.default_rng(dim + 7 * n_sub + 3 * tournament)
    queries, data, bias, (qids, strip_list, _, _), layout = _by_id_tile(
        rng, dim, b_dtype, n_sub)
    strip_rows = (qids >= 0).sum(dim=1, dtype=torch.int32)
    rows = queries.to(torch.bfloat16)
    kf, engaged = 20, set()
    assert len(layout) >= 2 and bool((strip_list == -1).any())
    assert bool(((strip_rows > 0) & (strip_rows < tss.C)).any())
    assert max(ns for (_, ns, _, _) in layout) == n_sub
    for (w_blocks, ns, start, count) in layout:
        seg = slice(start, start + count)
        args = (strip_list[seg], data, bias, w_blocks, ns, -2.0, kf,
                tournament, strip_rows[seg])
        want = tss.strip_class(strip_list[seg],
                               tss.group_queries(queries, qids[seg]),
                               *args[1:])
        got = tss.strip_class(strip_list[seg], rows, *args[1:],
                              qids=qids[seg])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        engaged.add(tss.tournament_engaged(kf, w_blocks * tss.MC, tournament))
    assert tournament in engaged


def test_tile_body_by_id_returns_the_grouped_path_exactly():
    """``_strip_tile_body`` with K1's class function (rows by id, one bf16
    cast of the tile's rows) returns what the grouped operand gives, on a
    query operand that is a column slice (not contiguous, as the truncated
    cache's) and with a per-pair constant."""
    rng = np.random.default_rng(5)
    queries, data, bias, plan, layout = _by_id_tile(rng, 96, "int8", 2)
    wide = torch.cat([queries, torch.ones(queries.shape[0], 32)], dim=1)
    q_mat = wide[:, :96]
    assert not q_mat.is_contiguous()
    ids = torch.arange(data.shape[0] * data.shape[1],
                       dtype=torch.int32).reshape(data.shape[:2])
    pair_const = torch.from_numpy(rng.random((50, 3)).astype(np.float32))
    k1 = tss._k1_class_fn(data, bias, -2.0, 20, True)
    grouped = tss.kernel_fn(
        lambda sl, a, w_blocks, n_sub, rows: tss.strip_class(
            sl, a, data, bias, w_blocks, n_sub, -2.0, 20, True, rows), "K1")
    assert k1.by_id and not grouped.by_id
    got, want = (tss._strip_tile_body(q_mat, *plan, ids, layout, 10, 20,
                                      fn, pair_const) for fn in (k1, grouped))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((got[1] >= 0).any())


@pytest.mark.parametrize("bad", ["int64", "one_dim", "strip_count",
                                 "qids_strided", "rows_strided",
                                 "grouped_operand"])
def test_class_call_refuses_bad_qids(bad):
    """The class call refuses qids that are not (S, C) int32 over the
    class's strips, and qids or query rows that are not contiguous."""
    rng = np.random.default_rng(2)
    sl, a, b, bias = _class_inputs(rng, 1, 1, 10)
    rows = torch.from_numpy(a.reshape(-1, a.shape[2])).to(torch.bfloat16)
    qids = torch.arange(rows.shape[0], dtype=torch.int32).reshape(a.shape[:2])
    if bad == "int64":
        qids = qids.long()
    elif bad == "one_dim":
        qids = qids.reshape(-1)
    elif bad == "strip_count":
        qids = qids[1:]
    elif bad == "qids_strided":
        qids = qids.t().contiguous().t()
    elif bad == "rows_strided":
        rows = rows.t().contiguous().t()
    else:
        rows = rows.reshape(a.shape)
    with pytest.raises(ValueError):
        tss.strip_class(torch.from_numpy(sl), rows, torch.from_numpy(b),
                        torch.from_numpy(bias), 1, 1, -2.0, 10, qids=qids)


@pytest.mark.cuda
def test_kernel_matches_plain_twin_on_card():
    """K1 against its plain twin on the card (runs where there is one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K1 is CUDA code with no CPU mode")
    rng = np.random.default_rng(21)
    sl, a, b, bias = _class_inputs(rng, 2, 2, 20)
    args = [torch.from_numpy(x).cuda() for x in (sl, a, b, bias)]
    args[1] = args[1].to(torch.bfloat16)
    got = tss.strip_class(*args, 2, 2, -2.0, 20, approx_ok=True)
    want = tss._strip_class_plain(*args, 2, 2, -2.0, 20, approx_ok=True)
    verdict = topk_agreement(want[0], want[1], got[0], got[1], rtol=5e-4,
                             atol=1e-2, mask=args[0] >= 0)
    assert verdict["ok"], verdict


def _gathered_class(rng, mask, dim, n_sub, kf=20, n_lists=6, s_pad=10):
    """One class call's operands whose bias a filter masked: int8 lists of
    w = 1024 lanes a sub-block, a random ``mask`` share of the lanes live
    ("half": every other lane of list 1's first sub-block and 129 lanes of
    list 2's, the others at 10%), list 0 dead, padding strips."""
    w = 1024
    m = w * n_sub
    b = rng.integers(-127, 128, (n_lists, m, dim)).astype(np.int8)
    bias = (rng.random((n_lists, m)) * 500).astype(np.float32)
    share = 0.1 if mask == "half" else mask
    bias[rng.random((n_lists, m)) >= share] = np.inf
    bias[0] = np.inf
    if mask == "half":
        lanes = np.arange(w)
        bias[1, :w] = np.where(lanes % 2 == 0, rng.random(w) * 500, np.inf)
        bias[2, :w] = np.where(lanes < 129, 3.0, np.inf)
    sl = rng.integers(0, n_lists, s_pad).astype(np.int32)
    sl[:3] = [0, 1, 2]
    sl[-2:] = -1
    a = (rng.standard_normal((s_pad, tss.C, dim)) * 2).astype(np.float32)
    return (torch.from_numpy(sl), torch.from_numpy(a).to(torch.bfloat16),
            torch.from_numpy(b), torch.from_numpy(bias), w // tss.MC, n_sub,
            -2.0, kf)


@pytest.mark.parametrize("n_sub", [1, 2])
@pytest.mark.parametrize("dim", [96, 128])
@pytest.mark.parametrize("mask", [0.1, 0.01, "half"])
def test_gathered_walk_equals_the_dense_exact_walk(mask, dim, n_sub):
    """K1's twin on the gathered walk against the same twin's dense walk
    with exact selection: the same +inf pattern, and on every finite slot
    the same value and offset; an +inf slot holds an offset inside the
    list. Random masks at 10% and 1% (fewer live lanes than kf: +inf
    slots), a sub-block exactly half live, one with 129 live lanes (a
    second tile), a dead list, padding strips."""
    rng = np.random.default_rng({0.1: 1, 0.01: 2, "half": 3}[mask] * 10
                                + dim + n_sub)
    args = _gathered_class(rng, mask, dim, n_sub)
    sl, bias, w, kf = args[0], args[3], args[4] * tss.MC, args[7]
    assert not tss.tournament_engaged(kf, w, True, gathered=True)
    dv, de = tss.strip_class(*args, approx_ok=False)
    gv, ge = tss.strip_class(*args, approx_ok=True, gathered=True)
    rows = (sl >= 0)[:, None, None].expand_as(dv)
    fin = torch.isfinite(dv) & rows
    assert torch.equal(fin, torch.isfinite(gv) & rows)
    assert torch.equal(dv[fin], gv[fin]) and torch.equal(de[fin], ge[fin])
    assert bool(fin.any()) and bool((~fin & rows).any())
    assert int(ge[rows].min()) >= 0 and int(ge[rows].max()) < n_sub * w
    if mask == "half":
        live = torch.isfinite(bias[1, :w]).sum()
        assert int(live) == w // 2
        assert torch.isfinite(gv[1]).all()


@pytest.mark.parametrize("family", ["ivf_pq", "ivf_flat"])
@pytest.mark.parametrize("share", [None, 0.1, 0.5, 0.6])
def test_the_search_takes_the_gathered_walk_under_any_filter(share, family,
                                                             monkeypatch):
    """The ragged searches hand K1 the gathered walk under a filter,
    whatever share of the ids it passes, and the dense walk without one;
    the filtered result holds no failing id."""
    from raft_tpu_torch.core.bitset import Bitset
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    g = torch.Generator().manual_seed(8)
    ds, qs = torch.randn(3000, 16, generator=g), torch.randn(20, 16,
                                                            generator=g)
    filt = None
    if share is not None:
        mask = np.zeros(3000, bool)
        mask[np.random.default_rng(1).permutation(3000)[:int(share * 3000)]] \
            = True
        filt = Bitset.from_mask(mask, device="cpu")
        assert filt.pass_rate() == share
    if family == "ivf_pq":
        index = ivf_pq.build(ds, ivf_pq.IvfPqParams(
            n_lists=4, pq_dim=8, group_size=512, kmeans_n_iters=3),
            device="cpu")
        search = lambda: ivf_pq.search(index, qs, 10, n_probes=2,  # noqa: E731
                                       filter=filt, backend="ragged",
                                       device="cpu")
    else:
        index = ivf_flat.build(ds, ivf_flat.IvfFlatParams(
            n_lists=4, group_size=512, kmeans_n_iters=3), device="cpu")
        search = lambda: ivf_flat.search(  # noqa: E731
            index, qs, 10, n_probes=2, filter=filt, backend="ragged",
            device="cpu")
    walks = []
    real = tss.strip_class

    def spy(*args, gathered=False, **kw):
        walks.append(gathered)
        return real(*args, gathered=gathered, **kw)

    monkeypatch.setattr(tss, "strip_class", spy)
    _, ids = search()
    assert walks and set(walks) == {filt is not None}
    if filt is not None:
        got = ids[ids >= 0].numpy()
        assert mask[got].all()
