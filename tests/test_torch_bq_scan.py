"""Port parity: raft_tpu_torch.ops.bq_scan (the plain twin of kernel K2 plus
strip_scan's plan and merge) and the SRHT rotation of
raft_tpu_torch.ops.linalg against the JAX package, on the same numpy
inputs.

Tolerances: the bit layouts (pack_sign_bits, pack_code_planes and their
inverses, extend_query_planes) are bit-equal; the Walsh–Hadamard transform
and the SRHT rotation agree within 1e-5 (fp32, same butterfly order);
strip-search candidates agree as ``topk_agreement`` judges them: values
within rtol 5e-4 (fp32 sums in another order can move a score across one
12-bit packing quantum, 2^-11 relative) plus an absolute floor of 1e-5 ×
the case's largest |score| (a score that cancels toward zero keeps the
fp32 noise of its larger terms), and ids equal except at near-ties
(values within 1e-3 relative). The JAX reference is
``bq_strip_search_traced(..., impl="jnp")``; one case runs the Pallas
kernel itself in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import bq_scan as jbq
from raft_tpu.ops import linalg as jlin
from raft_tpu.ops import strip_scan as jss
from raft_tpu_torch.ops import bq_scan as tbq
from raft_tpu_torch.ops import linalg as tlin
from raft_tpu_torch.ops import strip_scan as tss
from raft_tpu_torch.stats.metrics import topk_agreement

torch.set_num_threads(2)


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("rot_dim", [40, 128])
@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_bit_layouts_match_jax(bits, rot_dim):
    rng = np.random.default_rng(bits * 1000 + rot_dim)
    codes = rng.integers(0, 1 << bits, (33, rot_dim)).astype(np.uint8)
    want = _np(jbq.pack_code_planes(jnp.asarray(codes), bits))
    got = tbq.pack_code_planes(torch.from_numpy(codes), bits)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tbq.unpack_code_levels(got, rot_dim, bits).numpy(),
        _np(jbq.unpack_code_levels(jnp.asarray(want), rot_dim, bits)))
    signs = rng.choice([-1, 0, 1], (33, rot_dim)).astype(np.int8)
    packed = tbq.pack_sign_bits(torch.from_numpy(signs))
    np.testing.assert_array_equal(packed.numpy(),
                                  _np(jbq.pack_sign_bits(jnp.asarray(signs))))
    np.testing.assert_array_equal(
        tbq.unpack_sign_bits(packed, rot_dim).numpy(),
        _np(jbq.unpack_sign_bits(jnp.asarray(packed.numpy()), rot_dim)))
    q = rng.standard_normal((5, rot_dim)).astype(np.float32)
    np.testing.assert_array_equal(
        tbq.extend_query_planes(torch.from_numpy(q), bits).numpy(),
        _np(jbq.extend_query_planes(jnp.asarray(q), bits)))
    assert tbq.multibit_width(rot_dim, bits) == jbq.multibit_width(rot_dim, bits)


def test_plane_weighted_query_gives_the_level_product():
    """⟨ext(q), ±1 planes⟩ == ⟨q, levels⟩: the identity the multi-bit scan
    rests on, checked on the port's own functions."""
    rng = np.random.default_rng(5)
    codes = torch.from_numpy(rng.integers(0, 8, (7, 64)).astype(np.uint8))
    q = torch.from_numpy(rng.integers(-4, 5, (3, 64)).astype(np.float32))
    packed = tbq.pack_code_planes(codes, 3)
    pm1 = tbq._unpack_pm1(packed).float()
    levels = tbq.unpack_code_levels(packed, 64, 3).float()
    assert torch.equal(tbq.extend_query_planes(q, 3) @ pm1.T, q @ levels.T)


@pytest.mark.parametrize("dim", [8, 40, 128])
def test_srht_rotation_matches_jax(dim):
    rng = np.random.default_rng(dim)
    rot_dim = tlin.hadamard_rot_dim(dim)
    assert rot_dim == jlin.hadamard_rot_dim(dim)
    signs = rng.choice([-1.0, 1.0], rot_dim).astype(np.float32)
    x = rng.standard_normal((9, dim)).astype(np.float32)
    xp = np.pad(x, ((0, 0), (0, rot_dim - dim)))
    np.testing.assert_allclose(
        tlin.hadamard_transform(torch.from_numpy(xp)).numpy(),
        _np(jlin.hadamard_transform(jnp.asarray(xp))), rtol=1e-5, atol=1e-5)
    got = tlin.rotate_rows(torch.from_numpy(x), torch.from_numpy(signs),
                           "hadamard")
    want = _np(jlin.rotate_rows(jnp.asarray(x), jnp.asarray(signs), "hadamard"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # orthogonal: norms kept
    np.testing.assert_allclose(got.norm(dim=1).numpy(),
                               np.linalg.norm(x, axis=1), rtol=1e-5)


def test_srht_signs_and_rotation_kinds():
    g = torch.Generator().manual_seed(0)
    s = tlin.make_srht_signs(g, 64, torch.device("cpu"))
    assert s.shape == (64,) and s.dtype == torch.float32
    assert set(s.tolist()) == {-1.0, 1.0}
    with pytest.raises(ValueError, match="power-of-two"):
        tlin.make_srht_signs(g, 40, torch.device("cpu"))
    assert tlin.ROTATION_KINDS == jlin.ROTATION_KINDS
    with pytest.raises(ValueError, match="unknown rotation kind"):
        tlin.rotate_rows(torch.zeros(2, 8), s[:8], "givens")


def make_bq_lists(rng, n_lists, nb, lens):
    """Random packed code lists (any byte is a valid code), scale and bias
    at a strip-eligible padded size; scale 0 and bias +inf at padding."""
    chunks = max((int(max(lens)) + 511) // 512, 1)
    m = 512 * (1 << (chunks - 1).bit_length())
    codes = np.zeros((n_lists, m, nb), np.uint8)
    scale = np.zeros((n_lists, m), np.float32)
    bias = np.full((n_lists, m), np.inf, np.float32)
    ids = np.full((n_lists, m), -1, np.int32)
    nxt = 0
    for l in range(n_lists):
        n = lens[l]
        codes[l, :n] = rng.integers(0, 256, (n, nb))
        scale[l, :n] = rng.uniform(0.5, 2.0, n)
        bias[l, :n] = rng.normal(size=n) * 8 * nb
        ids[l, :n] = np.arange(nxt, nxt + n)
        nxt += n
    return codes, scale, bias, ids


def run_both(queries, probes, codes, scale, bias, ids, lens, k, approx_ok,
             impl="jnp", pair_const=None):
    classes, cls_ord = jss.class_info(np.asarray(lens), dim=queries.shape[1])
    counts = jss.class_counts_of(cls_ord, len(classes))
    jv, ji = jbq.bq_strip_search_traced(
        jnp.asarray(queries), jnp.asarray(probes), jnp.asarray(codes),
        jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(ids),
        jnp.asarray(cls_ord), tuple(classes), counts, k, k, -2.0,
        queries.shape[0], True,
        None if pair_const is None else jnp.asarray(pair_const),
        approx_ok, impl)
    t = torch.from_numpy
    tv, ti = tbq.bq_strip_search(
        t(queries), t(probes), t(codes), t(scale), t(bias), t(ids), lens, k,
        alpha=-2.0, approx_ok=approx_ok,
        pair_const=None if pair_const is None else t(pair_const))
    return t(np.array(jv)), t(np.array(ji)), tv, ti


def score_floor(v):
    """1e-5 × the largest |score|, leaving out ±inf and the ±3.4e38 the
    packing clamp leaves for -inf scores."""
    real = v[torch.isfinite(v) & (v.abs() < 1e38)]
    return 1e-5 * float(real.abs().max()) if real.numel() else 0.0


def assert_agree(jv, ji, tv, ti):
    verdict = topk_agreement(jv, ji, tv, ti, rtol=5e-4, atol=score_floor(jv),
                             tie_rtol=1e-3)
    assert verdict["ok"], verdict
    assert verdict["compared"] > 0
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32


CASES = {
    # skewed lengths with an empty list every query probes
    "skewed_empty": dict(n_lists=7, nb=2, q=40, p=3,
                         lens=[0, 900, 30, 1400, 5, 300, 1100]),
    # many lists, two length classes: the per-class strip remap
    "multi_class_remap": dict(n_lists=120, nb=1, q=150, p=4,
                              lens=[100, 900] * 60),
    # one list longer than one fetch: n_sub = 2 sub-blocks
    "n_sub": dict(n_lists=3, nb=1, q=31, p=2, lens=[6000, 40, 700]),
    # the main path's code width (rot_dim 128, one bit)
    "rot128": dict(n_lists=6, nb=16, q=60, p=2,
                   lens=[700, 20, 1500, 300, 0, 1000]),
}


@pytest.mark.parametrize("kf", [10, 20, 40])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bq_strip_search_matches_jax(case, kf):
    c = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) * 100 + kf)
    lens = np.asarray(c["lens"])
    codes, scale, bias, ids = make_bq_lists(rng, c["n_lists"], c["nb"], lens)
    queries = rng.standard_normal((c["q"], 8 * c["nb"])).astype(np.float32)
    probes = np.stack([rng.choice(c["n_lists"], c["p"], replace=False)
                       for _ in range(c["q"])]).astype(np.int32)
    if case == "skewed_empty":
        probes[:, 0] = 0
    assert_agree(*run_both(queries, probes, codes, scale, bias, ids, lens,
                           kf, approx_ok=True))


def test_bq_strip_search_matches_pallas_kernel_interpret():
    """The JAX Pallas kernel itself (interpret mode), with the per-pair
    constant and the exact (non-tournament) selection."""
    rng = np.random.default_rng(77)
    lens = np.array([600, 1200, 0, 90])
    codes, scale, bias, ids = make_bq_lists(rng, 4, 4, lens)
    bias[1, 1030:1040] = np.nan
    queries = rng.standard_normal((24, 32)).astype(np.float32)
    probes = np.stack([rng.choice(4, 2, replace=False)
                       for _ in range(24)]).astype(np.int32)
    pair_const = rng.normal(size=(24, 2)).astype(np.float32) * 10
    assert_agree(*run_both(queries, probes, codes, scale, bias, ids, lens, 20,
                           approx_ok=False, impl="pallas",
                           pair_const=pair_const))


@pytest.mark.parametrize("w_blocks,n_sub,kf,nb", [
    (2, 1, 20, 16), (1, 3, 40, 5), (1, 2, 64, 8), (2, 1, 10, 32)])
def test_bq_class_plain_twin_matches_jax(w_blocks, n_sub, kf, nb):
    """The per-class function itself: padding strips, dead lists and
    sub-blocks, ±inf/NaN bias lanes with scale 0 at padding, code widths
    that are and are not a multiple of 8 bytes. The reference is the
    Pallas kernel in interpret mode: like K2 it skips a sub-block whose
    bias lanes are all non-finite, where the jnp reference still ranks its
    -inf lanes."""
    rng = np.random.default_rng(w_blocks * 100 + n_sub * 10 + kf + nb)
    n_lists, s_pad, s_real = 5, 9, 6
    w = 512 * w_blocks
    m = w * n_sub
    codes = rng.integers(0, 256, (n_lists, m, nb)).astype(np.uint8)
    lens = rng.integers(kf, m + 1, n_lists)
    live = np.arange(m)[None] < lens[:, None]
    scale = np.where(live, rng.uniform(0.5, 2.0, (n_lists, m)), 0.0
                     ).astype(np.float32)
    bias = np.where(live, rng.random((n_lists, m)) * 500, np.inf
                    ).astype(np.float32)
    bias[0] = np.inf                                   # dead list
    if n_sub > 1:
        bias[1, :w] = np.inf                           # dead first sub-block
    u = rng.random((n_lists, m))
    bias[u < 0.01] = np.nan
    bias[(u >= 0.01) & (u < 0.02)] = -np.inf
    sl = rng.integers(0, n_lists, s_pad).astype(np.int32)
    sl[rng.permutation(s_pad)[:s_pad - s_real]] = -1   # padding strips
    a = (rng.standard_normal((s_pad, tss.C, 8 * nb)) * 2).astype(np.float32)
    jv, je = jbq._bq_class_call(
        jnp.asarray(sl), jnp.asarray(a, jnp.bfloat16), jnp.asarray(codes),
        jnp.asarray(scale)[:, None, :], jnp.asarray(bias)[:, None, :],
        w_blocks, n_sub, -2.0, kf, True, True)
    t = torch.from_numpy
    tv, te = tbq.bq_class(t(sl), t(a).to(torch.bfloat16), t(codes), t(scale),
                          t(bias), w_blocks, n_sub, -2.0, kf, approx_ok=True)
    jv = t(np.array(jv))
    live = t(sl) >= 0
    verdict = topk_agreement(jv, t(np.array(je)), tv, te, rtol=5e-4,
                             atol=score_floor(jv[live]), tie_rtol=1e-3,
                             mask=live)
    assert verdict["ok"], verdict
    assert verdict["compared"] > 0


def test_bq_tile_body_matches_jax():
    """One query tile on the same plan: the port's tile body (strip_scan's,
    with K2's class function) against the JAX package's, including the
    per-pair constant."""
    rng = np.random.default_rng(12)
    lens = np.array([900, 40, 2100, 600, 1300, 0])
    codes, scale, bias, ids = make_bq_lists(rng, 6, 4, lens)
    q, p, kf = 90, 3, 40
    queries = rng.standard_normal((q, 32)).astype(np.float32)
    probes = np.stack([rng.choice(6, p, replace=False)
                       for _ in range(q)]).astype(np.int32)
    pair_const = rng.normal(size=(q, p)).astype(np.float32) * 10
    classes, cls_ord = tss.class_info(lens, dim=32)
    counts = tss.class_counts_of(cls_ord, len(classes))
    starts, s_tot, layout = tss.static_layout(classes, counts, q, p)
    plan = tss._plan_device(torch.from_numpy(probes),
                            torch.from_numpy(cls_ord), 6, starts, s_tot)
    t = torch.from_numpy
    tv, ti = tbq._bq_tile_body(t(queries), *plan[:4], t(codes), t(scale),
                               t(bias), t(ids), layout, kf, kf, -2.0,
                               pair_const=t(pair_const), approx_ok=False)
    jv, ji = jbq._bq_tile_body(
        jnp.asarray(queries), *(jnp.asarray(x.numpy()) for x in plan[:4]),
        jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(ids), layout, kf, kf, -2.0, True, jnp.asarray(pair_const),
        False, "jnp")
    assert_agree(t(np.array(jv)), t(np.array(ji)), tv, ti)


def test_port_traced_search_matches_planned_search():
    """The traced driver (static worst-case layout, what ivf_bq.search
    runs) returns what the planned driver does."""
    rng = np.random.default_rng(4)
    lens = np.array([300, 2000, 700, 0, 1100])
    codes, scale, bias, ids = (torch.from_numpy(x) for x in
                               make_bq_lists(rng, 5, 2, lens))
    queries = torch.from_numpy(rng.standard_normal((70, 16)).astype(np.float32))
    probes = torch.from_numpy(np.stack([rng.choice(5, 3, replace=False)
                                        for _ in range(70)]).astype(np.int32))
    want = tbq.bq_strip_search(queries, probes, codes, scale, bias, ids, lens,
                               20, approx_ok=True)
    classes, cls_ord = tss.class_info(lens, dim=16)
    counts = tss.class_counts_of(cls_ord, len(classes))
    got = tbq.bq_strip_search_traced(
        queries, probes, codes, scale, bias, ids, torch.from_numpy(cls_ord),
        tuple(classes), counts, 20, 20, -2.0, 32, approx_ok=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_k2_matches_plain_twin_on_card():
    """K2 against its plain twin on the card (runs where there is one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K2 is CUDA code with no CPU mode")
    rng = np.random.default_rng(31)
    lens = np.array([700, 1500, 300])
    codes, scale, bias, _ = make_bq_lists(rng, 3, 16, lens)
    sl = torch.tensor([0, -1, 1, 2, 1], dtype=torch.int32).cuda()
    a = torch.from_numpy(rng.standard_normal((5, tss.C, 128)).astype(
        np.float32)).to(torch.bfloat16).cuda()
    args = [t.cuda() for t in map(torch.from_numpy, (codes, scale, bias))]
    got = tbq.bq_class(sl, a, *args, 4, 1, -2.0, 80)
    want = tbq._bq_class_plain(sl, a, *args, 4, 1, -2.0, 80)
    verdict = topk_agreement(want[0], want[1], got[0], got[1], rtol=5e-4,
                             atol=1e-2, mask=sl >= 0)
    assert verdict["ok"], verdict
