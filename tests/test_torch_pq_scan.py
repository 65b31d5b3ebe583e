"""K5 port parity: the query→list grouping and the LUT list scan's plain
twins against the JAX package's ``raft_tpu.ops.pq_scan`` on the same numpy
inputs — the grouping bit for bit (drops included), the grouped twin
against ``pq_scan(interpret=True)`` and ``pq_scan_reference`` (bitwise on
integer-valued LUTs, whose fp32 sums are exact; rtol 1e-5 / atol 1e-4 on
real-valued ones, the JAX test's own bar for summation order), the pair
twin against both re-indexed (bitwise on integer LUTs, with a skewed list
load and lists no pair probes), the block table K5 launches over, and the
kernel itself on a card (skipped without one)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import pq_scan as jps
from raft_tpu_torch.ops import pq_scan as tps

torch.set_num_threads(2)


@pytest.mark.parametrize("case", ["random", "over_cap", "one_list"])
def test_group_probed_pairs_bitwise(case):
    rng = np.random.default_rng(len(case))
    if case == "random":            # generous cap: nothing dropped
        q, p, L, cap = 32, 4, 16, 32
        probes = rng.integers(0, L, (q, p))
    elif case == "over_cap":        # a hot list: loads above the cap
        q, p, L, cap = 64, 6, 12, 16
        probes = np.where(rng.random((q, p)) < 0.4, 3, rng.integers(0, L, (q, p)))
    else:                           # every pair on one list
        q, p, L, cap = 8, 2, 4, 8
        probes = np.zeros((q, p))
    probes = probes.astype(np.int32)
    jq, js = jps.group_probed_pairs(jnp.asarray(probes), L, cap)
    tq, ts = tps.group_probed_pairs(torch.from_numpy(probes), L, cap)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int32 and ts.dtype == torch.int32
    if case != "random":
        assert int((ts < 0).sum()) > 0      # the case does drop pairs
    # every kept pair is found at its (list, slot)
    for qi, pi in zip(*np.nonzero(ts.numpy() >= 0)):
        assert tq[probes[qi, pi], ts[qi, pi]] == qi


def _scan_inputs(rng, nc, s, m, qpl, integer, L=8):
    if integer:
        luts = rng.integers(-64, 65, (L, qpl, s * nc)).astype(np.float32)
        b_sum = rng.integers(-500, 500, (L, m)).astype(np.float32)
    else:
        luts = rng.normal(size=(L, qpl, s * nc)).astype(np.float32)
        b_sum = rng.normal(size=(L, m)).astype(np.float32)
    b_sum[:, -7:] = np.inf           # padding sentinel flows through
    b_sum[-1] = np.inf               # an empty list
    luts[:, 1] = 0.0                 # an empty slot: exactly b_sum
    codes = rng.integers(0, nc, (L, s, m)).astype(np.uint8)
    return luts, codes, b_sum


SHAPES = [(16, 8, 128, 16), (16, 64, 256, 32), (64, 16, 128, 16),
          (256, 8, 128, 16)]


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("nc,s,m,qpl", SHAPES)
def test_twin_matches_jax_kernel_and_reference(nc, s, m, qpl, integer):
    luts, codes, b_sum = _scan_inputs(np.random.default_rng(nc + s + m),
                                      nc, s, m, qpl, integer)
    luts_bf = jnp.asarray(luts, jnp.bfloat16)
    want_k = np.asarray(jps.pq_scan(luts_bf, jnp.asarray(codes),
                                    jnp.asarray(b_sum), nc, interpret=True))
    want_r = np.asarray(jps.pq_scan_reference(luts_bf, jnp.asarray(codes),
                                              jnp.asarray(b_sum), nc))
    got = tps.pq_scan_reference(torch.from_numpy(luts).to(torch.bfloat16),
                                torch.from_numpy(codes),
                                torch.from_numpy(b_sum), nc).numpy()
    assert got.shape == (8, qpl, m) and got.dtype == np.float32
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want_r))
    np.testing.assert_array_equal(got[:, 1], b_sum)
    for want in (want_k, want_r):
        if integer:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_twin_chunks_lists_without_changing_the_result(monkeypatch):
    luts, codes, b_sum = _scan_inputs(np.random.default_rng(5), 32, 8, 128,
                                      16, integer=True)
    args = (torch.from_numpy(luts).to(torch.bfloat16),
            torch.from_numpy(codes), torch.from_numpy(b_sum), 32)
    whole = tps.pq_scan_reference(*args)
    monkeypatch.setattr(tps, "_PLAIN_CHUNK_BYTES", 1)     # one list a step
    assert torch.equal(tps.pq_scan_reference(*args), whole)


@pytest.mark.cuda
def test_kernel_matches_twin_on_a_card():
    """K5 against its twin on the card: integer-valued LUTs bit for bit,
    an m that is no multiple of 4, and a partial block of slots."""
    if not torch.cuda.is_available():
        pytest.skip("K5 is a CUDA kernel (csrc/pq_scan.cu): it builds and "
                    "runs only on a machine with an NVIDIA card")
    rng = np.random.default_rng(9)
    for nc, s, m, qpl in [(256, 64, 3968, 16), (16, 8, 130, 20)]:
        luts, codes, b_sum = _scan_inputs(rng, nc, s, m, qpl, integer=True)
        args = (torch.from_numpy(luts).to(torch.bfloat16).cuda(),
                torch.from_numpy(codes).cuda(),
                torch.from_numpy(b_sum).cuda(), nc)
        before = tps.PQ_KERNEL.launches
        got = tps.pq_scan(*args)
        torch.cuda.synchronize()
        assert tps.PQ_KERNEL.launches == before + 1
        assert torch.equal(got, tps.pq_scan_reference(*args))


def _pair_inputs(rng, nc, s, m, q, p, L, integer=True):
    """A query tile's probed pairs on a skewed load: 80% of the queries
    probe list 2, lists ≥ L - 2 are never probed; per-query LUT rows."""
    probes = np.stack([rng.permutation(L - 2)[:p] for _ in range(q)])
    for i in np.nonzero(rng.random(q) < 0.8)[0]:
        if 2 not in probes[i]:
            probes[i, 0] = 2
    luts, codes, b_sum = _scan_inputs(rng, nc, s, m, q, integer, L=L)
    return probes.astype(np.int32), luts[0], codes, b_sum


def _pairs_of(probes):
    flat = probes.reshape(-1)
    order = np.argsort(flat, kind="stable")
    p = probes.shape[1]
    return [torch.from_numpy(x.astype(np.int32)) for x in
            (order // p, flat[order], order)]


@pytest.mark.parametrize("nc,s,m", [(16, 8, 128), (256, 8, 130), (64, 16, 256)])
def test_pair_twin_is_the_grouped_twin_reindexed(nc, s, m):
    """Each pair's scores equal, bit for bit, its (list, slot) row of the
    grouped scan over group_probed_pairs' blocks at a cap no list exceeds,
    and, where m suits its 128-entry tiling, the JAX kernel's (interpret
    mode) row there."""
    rng = np.random.default_rng(nc + s + m)
    q, p, L = 40, 3, 10
    probes, luts, codes, b_sum = _pair_inputs(rng, nc, s, m, q, p, L)
    load = np.bincount(probes.reshape(-1), minlength=L)
    assert load.max() > 2 * q * p / L and (load[-2:] == 0).all()
    luts_t = torch.from_numpy(luts).to(torch.bfloat16)
    pl, plist, pout = _pairs_of(probes)
    got = tps.pq_scan_pairs_reference(luts_t, pl, plist, pout,
                                      torch.from_numpy(codes),
                                      torch.from_numpy(b_sum), nc)
    assert got.shape == (q * p, m) and got.dtype == torch.float32
    cap = -(-int(load.max()) // 16) * 16      # the JAX kernel's 16-slot tiling
    qids, slot = tps.group_probed_pairs(torch.from_numpy(probes), L, cap)
    assert bool((slot >= 0).all())
    grouped = luts_t[qids.clamp(min=0).long()]
    grouped[qids < 0] = 0
    want = tps.pq_scan_reference(grouped, torch.from_numpy(codes),
                                 torch.from_numpy(b_sum), nc)
    pb = torch.from_numpy(probes).long()
    want_pairs = want[pb, slot.long()].reshape(q * p, m)
    assert torch.equal(got, want_pairs)
    np.testing.assert_array_equal(np.isinf(got.numpy()),
                                  np.isinf(b_sum[probes.reshape(-1)]))
    if m % 128:               # the JAX kernel's blocks need m % 128 == 0
        return
    want_k = np.asarray(jps.pq_scan(jnp.asarray(grouped.float().numpy(),
                                                jnp.bfloat16),
                                    jnp.asarray(codes), jnp.asarray(b_sum),
                                    nc, interpret=True))
    np.testing.assert_array_equal(
        got.numpy(), want_k[probes, slot.numpy()].reshape(q * p, m))


def test_pair_twin_chunks_without_changing_the_result(monkeypatch):
    rng = np.random.default_rng(21)
    probes, luts, codes, b_sum = _pair_inputs(rng, 32, 8, 128, 24, 2, 8)
    args = (torch.from_numpy(luts).to(torch.bfloat16), *_pairs_of(probes),
            torch.from_numpy(codes), torch.from_numpy(b_sum), 32)
    whole = tps.pq_scan_pairs_reference(*args)
    monkeypatch.setattr(tps, "_PLAIN_CHUNK_BYTES", 1)     # one pair a step
    assert torch.equal(tps.pq_scan_pairs_reference(*args), whole)
    assert torch.equal(tps.pq_scan_pairs(*args), whole)   # CPU: the twin


def test_pair_blocks_cover_every_pair_once():
    """The block table: runs of ≤ 16 pairs of one list, in sorted order,
    every pair in exactly one block, lists with no pair in none, and the
    spare rows past the real blocks empty."""
    rng = np.random.default_rng(4)
    lists = np.sort(np.concatenate([np.full(37, 3), np.full(16, 5),
                                    rng.integers(6, 12, 40)])).astype(np.int32)
    blocks = tps.pair_blocks(torch.from_numpy(lists), 12).numpy()
    assert blocks.dtype == np.int32
    assert blocks.shape[0] == -(-lists.size // 16) + 12
    real = blocks[blocks[:, 2] > 0]
    assert (blocks[len(real):, 2] == 0).all()
    covered = np.concatenate([np.arange(f, f + c) for _, f, c in real])
    np.testing.assert_array_equal(covered, np.arange(lists.size))
    for lst, f, c in real:
        assert 1 <= c <= 16 and (lists[f:f + c] == lst).all()
    assert [int(c) for lst, _, c in real if lst == 3] == [16, 16, 5]
    assert {int(x) for x in real[:, 0]} == set(lists.tolist())


def test_pair_entry_rejects_what_the_kernel_cannot_take():
    luts = torch.zeros((4, 8 * 16), dtype=torch.bfloat16)
    codes = torch.zeros((2, 8, 128), dtype=torch.uint8)
    b_sum = torch.zeros((2, 128))
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        tps.pq_scan_pairs(luts, idx, idx, idx, codes, b_sum, 12)
    with pytest.raises(ValueError, match="inconsistent"):
        tps.pq_scan_pairs(luts, idx, idx, idx, codes, b_sum, 32)
    with pytest.raises(ValueError, match="pair_out"):
        tps.pq_scan_pairs(luts, idx, idx, idx[:2], codes, b_sum, 16)
    with pytest.raises(TypeError, match="pair_list"):
        tps.pq_scan_pairs(luts, idx, idx.long(), idx, codes, b_sum, 16)
    with pytest.raises(TypeError, match="luts"):
        tps.pq_scan_pairs(luts.float(), idx, idx, idx, codes, b_sum, 16)


@pytest.mark.cuda
def test_pair_kernel_matches_twin_on_a_card():
    """K5 through the pair entry on the card, bit for bit on integer LUTs,
    a skewed load past 16 pairs a list and lists no pair probes."""
    if not torch.cuda.is_available():
        pytest.skip("K5 is a CUDA kernel (csrc/pq_scan.cu): it builds and "
                    "runs only on a machine with an NVIDIA card")
    rng = np.random.default_rng(10)
    for nc, s, m in [(256, 64, 3968), (16, 8, 130)]:
        probes, luts, codes, b_sum = _pair_inputs(rng, nc, s, m, 96, 4, 16)
        args = (torch.from_numpy(luts).to(torch.bfloat16).cuda(),
                *[t.cuda() for t in _pairs_of(probes)],
                torch.from_numpy(codes).cuda(),
                torch.from_numpy(b_sum).cuda(), nc)
        before = tps.PQ_KERNEL.launches
        got = tps.pq_scan_pairs(*args)
        torch.cuda.synchronize()
        assert tps.PQ_KERNEL.launches == before + 1
        assert torch.equal(got, tps.pq_scan_pairs_reference(
            *[t.cpu() if torch.is_tensor(t) else t for t in args]).cuda())
