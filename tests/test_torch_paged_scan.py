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

from paged_cases import LAYOUTS, paged_inputs, sub_live_of
from raft_tpu.ops import bq_scan as jbq
from raft_tpu.ops import strip_scan as jss
from raft_tpu_torch.ops import bq_scan as tbq
from raft_tpu_torch.ops import strip_scan as tss

torch.set_num_threads(2)


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
    ("r32_w128_nsub1", "bf16"), ("r64_w128_nsub2", "fp32"),
    ("serve_r128_w256_nsub2", "uint8"), ("serve_r128_w256_nsub2", "int8")])
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
