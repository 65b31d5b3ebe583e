"""Port parity: the paged halves of raft_tpu_torch.ops.strip_scan (the plain
twin of kernel K3) and raft_tpu_torch.ops.bq_scan (the twin of K4) against
the JAX package's paged Pallas kernels in interpret mode and their jnp
references, on the same numpy inputs.

The class-level comparisons are bitwise: queries are small integers and
payloads are integers or quarter-integers, so every fp32 sum of bf16
products is exact and the summation order cannot move a bit; the 1-bit
scales are eighths, so ``(alpha·s)·scale`` is exact too and XLA may fuse
it with the bias add without moving a bit. Scores are
kept away from exact zero (a random fractional bias), where the JAX
package's packed select loses the sign of zero under XLA's denormal flush.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import bq_scan as jbq
from raft_tpu.ops import strip_scan as jss
from raft_tpu_torch.ops import bq_scan as tbq
from raft_tpu_torch.ops import strip_scan as tss

torch.set_num_threads(2)

# name → (page_rows, table_width, ppf, n_sub)
LAYOUTS = {
    # 8-row pages, two sub-blocks of 8 pages (w = 64 < one 128-column tile)
    "r8_w64_nsub2": (8, 16, 8, 2),
    # 64-row pages, two sub-blocks of 2 pages (w = 128)
    "r64_w128_nsub2": (64, 4, 2, 2),
    # 32-row pages, one sub-block of 4 pages
    "r32_w128_nsub1": (32, 4, 4, 1),
}


def paged_inputs(rng, layout, payload, n_lists=6, cap_pages=48, dim=24,
                 s_real=7, s_pad=10):
    """A synthetic paged class: chains of 0, 1, partial and full length,
    a list whose first sub-block is all +inf (filtered or deleted), a chain
    ending exactly on a sub-block boundary, tombstones and never-filled
    tail slots at +inf, NaN payload in page 0 (never chained, but what the
    TPU kernels' gather reads for absent slots), padding strips.
    ``payload`` is a numpy dtype name or ``("bits", b)`` for packed codes
    of b bits (rot_dim = dim); ``layout`` a name of LAYOUTS or its
    ``(page_rows, table_width, ppf, n_sub)``."""
    R, W, ppf, n_sub = LAYOUTS[layout] if isinstance(layout, str) else layout
    chains = np.array([0, 1, 2, ppf, min(W, ppf + 1), W][:n_lists], np.int32)
    table = np.full((n_lists, W), -1, np.int32)
    free = rng.permutation(np.arange(1, cap_pages))
    nxt = 0
    for l in range(n_lists):
        table[l, :chains[l]] = free[nxt:nxt + chains[l]]
        nxt += chains[l]
    if isinstance(payload, tuple):
        nb = payload[1] * dim // 8
        pages = rng.integers(0, 256, (cap_pages, R, nb)).astype(np.uint8)
        a_width = 8 * nb
    elif payload in ("uint8", "int8"):
        lo, hi = (0, 256) if payload == "uint8" else (-127, 128)
        pages = rng.integers(lo, hi, (cap_pages, R, dim)).astype(payload)
        a_width = dim
    else:
        pages = (rng.integers(-32, 33, (cap_pages, R, dim)) / 4.0).astype(
            np.float32)
        pages[0] = np.nan
        a_width = dim
    bias = rng.uniform(0.1, 900.0, (cap_pages, R)).astype(np.float32)
    bias[rng.random((cap_pages, R)) < 0.1] = np.inf          # tombstones
    for l in range(n_lists):                                  # tail fill
        if chains[l]:
            bias[table[l, chains[l] - 1], R // 2 + 1:] = np.inf
    if n_sub > 1 and chains[4] > ppf:
        bias[table[4, :ppf]] = np.inf          # first sub-block all +inf
    bias[0] = np.nan                           # never ranks: not chained
    sl = rng.integers(0, n_lists, s_pad).astype(np.int32)
    sl[:n_lists] = np.arange(n_lists)          # every list scanned once
    sl[n_lists + rng.permutation(s_pad - n_lists)[:s_pad - s_real]] = -1
    a = rng.integers(-3, 4, (s_pad, tss.C, a_width)).astype(np.float32)
    return dict(sl=sl, table=table, chains=chains, pages=pages, bias=bias,
                a=a, R=R, W=W, ppf=ppf, n_sub=n_sub)


def sub_live_of(c):
    return tss.paged_sub_live(torch.from_numpy(c["bias"]),
                              torch.from_numpy(c["table"]),
                              torch.from_numpy(c["chains"]), c["ppf"],
                              c["n_sub"])


def assert_bitwise(live, jax_out, torch_out):
    jv, je = (np.asarray(x) for x in jax_out)
    tv, te = (x.numpy() for x in torch_out)
    np.testing.assert_array_equal(tv[live], jv[live])
    np.testing.assert_array_equal(te[live], je[live])


def test_paged_plan_and_eligibility_match_jax():
    for table_width in (1, 2, 4, 8, 32, 64, 128):
        for page_rows in (8, 16, 32, 64, 128, 256):
            for row_bytes in (16, 128, 512, 4096):
                for kf in (1, 10, 40, 320, 512, 600):
                    assert tss.paged_plan(table_width, page_rows, row_bytes,
                                          kf) == jss.paged_plan(
                        table_width, page_rows, row_bytes, kf)
                    assert tss.paged_eligible(table_width, page_rows,
                                              row_bytes, kf) == \
                        jss.paged_eligible(table_width, page_rows, row_bytes,
                                           kf)


def test_paged_sub_live_matches_jax_formula():
    rng = np.random.default_rng(5)
    c = paged_inputs(rng, "r8_w64_nsub2", "fp32")
    got = sub_live_of(c).numpy()
    # the inline derivation of raft_tpu.ops.strip_scan.paged_strip_search_traced
    table, ppf, n_sub = jnp.asarray(c["table"]), c["ppf"], c["n_sub"]
    page_live = jnp.any(jnp.isfinite(jnp.asarray(c["bias"])), axis=1)
    slot_live = page_live[jnp.maximum(table, 0)] & (table >= 0)
    slot_live = slot_live[:, :n_sub * ppf]
    pos = jnp.arange(n_sub * ppf)[None, :]
    slot_live = slot_live & (pos < jnp.asarray(c["chains"])[:, None])
    want = np.asarray(jnp.any(slot_live.reshape(-1, n_sub, ppf), axis=2)
                      ).astype(np.int32).reshape(-1)
    np.testing.assert_array_equal(got, want)
    assert got.reshape(-1, n_sub)[4, 0] == 0 and got.reshape(-1, n_sub)[4, 1]


@pytest.mark.parametrize("kf", [10, 40])
@pytest.mark.parametrize("layout,payload", [
    ("r8_w64_nsub2", "uint8"), ("r64_w128_nsub2", "int8"),
    ("r32_w128_nsub1", "bf16"), ("r64_w128_nsub2", "fp32")])
def test_paged_class_twin_is_bitwise_the_jax_kernel(layout, payload, kf):
    rng = np.random.default_rng(kf * 10 + sorted(LAYOUTS).index(layout))
    c = paged_inputs(rng, layout, payload)
    sub_live = sub_live_of(c)
    pages_j = jnp.asarray(c["pages"])
    pages_t = torch.from_numpy(c["pages"])
    if payload == "bf16":
        pages_j = pages_j.astype(jnp.bfloat16)
        pages_t = pages_t.to(torch.bfloat16)
    args_j = (jnp.asarray(c["sl"]), jnp.asarray(c["table"].reshape(-1)),
              jnp.asarray(c["chains"]), jnp.asarray(sub_live.numpy()),
              jnp.asarray(c["a"], jnp.bfloat16), pages_j,
              jnp.asarray(c["bias"]))
    static = (c["ppf"], c["n_sub"], c["R"], c["W"], -2.0, kf)
    kern = jss._paged_class_call(*args_j, *static, True)
    ref = jss._paged_class_jnp(*args_j, *static)
    got = tss.paged_class(
        torch.from_numpy(c["sl"]), torch.from_numpy(c["table"].reshape(-1)),
        torch.from_numpy(c["chains"]), sub_live,
        torch.from_numpy(c["a"]).to(torch.bfloat16), pages_t,
        torch.from_numpy(c["bias"]), *static)
    live = c["sl"] >= 0
    assert_bitwise(live, kern, got)
    assert_bitwise(live, ref, got)
    # the empty list's strip reads +inf at offsets 0..kf-1
    empty = np.nonzero(c["sl"] == 0)[0][0]
    assert torch.isinf(got[0][empty]).all()
    assert torch.equal(got[1][empty, 0], torch.arange(kf, dtype=torch.int32))


@pytest.mark.parametrize("bits,kf", [(1, 10), (2, 20), (4, 40), (1, 80)])
def test_paged_bq_class_twin_is_bitwise_the_jax_kernel(bits, kf):
    rng = np.random.default_rng(100 + bits * 10 + kf)
    c = paged_inputs(rng, "r64_w128_nsub2", ("bits", bits), dim=16)
    scale = (rng.integers(4, 17, c["bias"].shape) / 8.0).astype(np.float32)
    sub_live = sub_live_of(c)
    static = (c["ppf"], c["n_sub"], c["R"], c["W"], -2.0, kf)
    args_j = (jnp.asarray(c["sl"]), jnp.asarray(c["table"].reshape(-1)),
              jnp.asarray(c["chains"]), jnp.asarray(sub_live.numpy()),
              jnp.asarray(c["a"], jnp.bfloat16), jnp.asarray(c["pages"]),
              jnp.asarray(scale), jnp.asarray(c["bias"]))
    kern = jbq._paged_bq_class_call(*args_j, *static, True)
    got = tbq.paged_bq_class(
        torch.from_numpy(c["sl"]), torch.from_numpy(c["table"].reshape(-1)),
        torch.from_numpy(c["chains"]), sub_live,
        torch.from_numpy(c["a"]).to(torch.bfloat16),
        torch.from_numpy(c["pages"]), torch.from_numpy(scale),
        torch.from_numpy(c["bias"]), *static)
    assert_bitwise(c["sl"] >= 0, kern, got)


def test_paged_ids_translate_through_the_table():
    page_ids = torch.arange(40, dtype=torch.int32).reshape(5, 8)
    table = torch.tensor([[3, 1, -1], [0, -1, -1]], dtype=torch.int32)
    ids = tss.PagedIds(page_ids, table, 8)
    got = ids[torch.tensor([[0, 0, 0, 1]]), torch.tensor([[2, 9, 17, 3]])]
    assert got.tolist() == [[26, 9, -1, 3]]


def test_paged_strip_search_matches_jax():
    """The whole paged search at kernel level (plan, K3's twin, merge with
    the page-table id translation) against JAX's paged_strip_search_traced
    in interpret mode; two query tiles, a pair constant."""
    rng = np.random.default_rng(7)
    c = paged_inputs(rng, "r64_w128_nsub2", "uint8")
    page_ids = rng.permutation(c["pages"].shape[0] * c["R"]).reshape(
        c["pages"].shape[:2]).astype(np.int32)
    page_ids[~np.isfinite(c["bias"])] = -1
    q, p, k = 70, 3, 12
    queries = rng.integers(-3, 4, (q, c["a"].shape[2])).astype(np.float32)
    probes = np.stack([rng.choice(6, p, replace=False)
                       for _ in range(q)]).astype(np.int32)
    pair_const = rng.uniform(-5, 5, (q, p)).astype(np.float32)
    jv, ji = jss.paged_strip_search_traced(
        jnp.asarray(queries), jnp.asarray(probes), jnp.asarray(c["pages"]),
        jnp.asarray(c["bias"]), jnp.asarray(page_ids),
        jnp.asarray(c["table"]), jnp.asarray(c["chains"]), k, k, -2.0, 40,
        True, pair_const=jnp.asarray(pair_const))
    tv, ti = tss.paged_strip_search_traced(
        torch.from_numpy(queries), torch.from_numpy(probes),
        torch.from_numpy(c["pages"]), torch.from_numpy(c["bias"]),
        torch.from_numpy(page_ids), torch.from_numpy(c["table"]),
        torch.from_numpy(c["chains"]), k, k, -2.0, 40,
        pair_const=torch.from_numpy(pair_const))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def _cuda_case(layout, payload, kf):
    rng = np.random.default_rng(31)
    c = paged_inputs(rng, layout, payload)
    dev = torch.device("cuda")
    sub_live = sub_live_of(c).to(dev)
    pages = torch.from_numpy(c["pages"]).to(dev)
    args = (torch.from_numpy(c["sl"]).to(dev),
            torch.from_numpy(c["table"].reshape(-1)).to(dev),
            torch.from_numpy(c["chains"]).to(dev), sub_live,
            torch.from_numpy(c["a"]).to(dev, torch.bfloat16), pages,
            torch.from_numpy(c["bias"]).to(dev))
    return c, args, (c["ppf"], c["n_sub"], c["R"], c["W"], -2.0, kf)


@pytest.mark.cuda
def test_k3_matches_plain_twin_on_card():
    """K3 against its plain twin on the card (runs where there is one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K3 is CUDA code with no CPU mode")
    c, args, static = _cuda_case("r8_w64_nsub2", "uint8", 20)
    got = tss.paged_class(*args, *static)
    want = tss._paged_class_plain(*args, *static)
    live = args[0] >= 0
    assert torch.equal(got[0][live], want[0][live])
    fin = torch.isfinite(want[0][live])
    assert torch.equal(got[1][live][fin], want[1][live][fin])


# K4 on the card: (layout, bits, rot_dim, kf, the product loop the plan
# must pick) — wgmma wherever the code row is a multiple of 8 bytes
K4_CARD_CASES = {
    "r64_nb4_bits2_kf40": ("r64_w128_nsub2", 2, 16, 40, "mma.sync"),
    "nb16_kf40": ((128, 8, 4, 2), 1, 128, 40, "wgmma"),
    "nb16_kf80": ((128, 8, 4, 2), 1, 128, 80, "wgmma"),
    "nb16_kf320": ((128, 8, 4, 2), 1, 128, 320, "wgmma"),
    "nb16_n_sub1_kf80": ((128, 4, 4, 1), 1, 128, 80, "wgmma"),
    "bits2_nb32_kf80": ((128, 8, 4, 2), 2, 128, 80, "wgmma"),
    "nb5_kf80": ("r64_w128_nsub2", 1, 40, 80, "mma.sync"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K4_CARD_CASES))
def test_k4_matches_plain_twin_on_card(case):
    """K4 against its plain twin on the card (runs where there is one), on
    each product loop, bit for bit (integer queries and codes: every sum is
    exact), and the launch reports the loop its plan picks."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K4 is CUDA code with no CPU mode")
    layout, bits, dim, kf, loop = K4_CARD_CASES[case]
    rng = np.random.default_rng(32)
    c = paged_inputs(rng, layout, ("bits", bits), dim=dim)
    dev = torch.device("cuda")
    scale = torch.from_numpy(rng.uniform(0.5, 2.0, c["bias"].shape).astype(
        np.float32)).to(dev)
    args = (torch.from_numpy(c["sl"]).to(dev),
            torch.from_numpy(c["table"].reshape(-1)).to(dev),
            torch.from_numpy(c["chains"]).to(dev), sub_live_of(c).to(dev),
            torch.from_numpy(c["a"]).to(dev, torch.bfloat16),
            torch.from_numpy(c["pages"]).to(dev), scale,
            torch.from_numpy(c["bias"]).to(dev))
    static = (c["ppf"], c["n_sub"], c["R"], c["W"], -2.0, kf)
    got = tbq.paged_bq_class(*args, *static)
    assert tbq.PAGED_BQ_KERNEL.loop == loop
    want = tbq._paged_bq_class_plain(*args, *static)
    live = args[0] >= 0
    assert torch.equal(got[0][live], want[0][live])
    fin = torch.isfinite(want[0][live])
    assert torch.equal(got[1][live][fin], want[1][live][fin])
