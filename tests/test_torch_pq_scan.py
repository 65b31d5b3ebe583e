"""K5 port parity: the query→list grouping and the LUT list scan's plain
twin against the JAX package's ``raft_tpu.ops.pq_scan`` on the same numpy
inputs — the grouping bit for bit (drops included), the twin against
``pq_scan(interpret=True)`` and ``pq_scan_reference`` (bitwise on
integer-valued LUTs, whose fp32 sums are exact; rtol 1e-5 / atol 1e-4 on
real-valued ones, the JAX test's own bar for summation order), and the
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
