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
