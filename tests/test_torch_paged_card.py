"""K3 and K4, the paged strip-scan kernels, against their plain twins on an
NVIDIA card. The tests carry the ``cuda`` marker and skip without a card.
This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed: ``python -m pytest --noconftest -p
no:cacheprovider -q tests/test_torch_paged_card.py`` (``--noconftest``:
the suite's conftest configures JAX).

Inputs are integer queries and integer (or quarter-integer) payloads, so
every fp32 sum is exact and kernel and twin agree bit for bit.
"""

import numpy as np
import pytest
import torch

from paged_cases import paged_inputs, sub_live_of
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.neighbors._filtering import apply_filter_bias
from raft_tpu_torch.ops import bq_scan as tbq
from raft_tpu_torch.ops import strip_scan as tss


def _cuda_args(c, dev):
    """The class call's tensors of paged_inputs ``c`` on ``dev``."""
    pages = torch.from_numpy(c["pages"])
    if c["pages"].dtype == np.float32 and c.get("bf16"):
        pages = pages.to(torch.bfloat16)
    return (torch.from_numpy(c["sl"]).to(dev),
            torch.from_numpy(c["table"].reshape(-1)).to(dev),
            torch.from_numpy(c["chains"]).to(dev), sub_live_of(c).to(dev),
            torch.from_numpy(c["a"]).to(dev, torch.bfloat16), pages.to(dev),
            torch.from_numpy(c["bias"]).to(dev))


def _nan_past_chains(c):
    """NaN bias (and NaN float payload) in every page no chain holds: the
    rows past the chains, which no kernel may rank."""
    held = np.zeros(c["pages"].shape[0], bool)
    held[c["table"][c["table"] >= 0]] = True
    c["bias"][~held] = np.nan
    if c["pages"].dtype == np.float32:
        c["pages"][~held] = np.nan
    return c


def _filtered(c, rng):
    """The class's bias pool under a search filter, built as a search
    builds it (``apply_filter_bias`` of a ``Bitset`` over the rows' ids):
    every row of lists 1 and 4 fails (whole dead sub-blocks, which the
    plan then skips), half the other rows fail at random."""
    cap, rows = c["bias"].shape
    ids = np.arange(cap * rows).reshape(cap, rows)
    mask = rng.random(cap * rows) < 0.5
    for lst in (1, 4):
        held = c["table"][lst][c["table"][lst] >= 0]
        mask[ids[held].reshape(-1)] = False
    c["bias"] = apply_filter_bias(
        torch.from_numpy(c["bias"]), torch.from_numpy(ids),
        Bitset.from_mask(mask, device="cpu")).numpy()
    return c


def _assert_matches_twin(args, static):
    got = tss.paged_class(*args, *static)
    loop = tss.PAGED_KERNEL.loop
    want = tss._paged_class_plain(*args, *static)
    live = args[0] >= 0
    assert torch.equal(got[0][live], want[0][live])
    fin = torch.isfinite(want[0][live])
    assert torch.equal(got[1][live][fin], want[1][live][fin])
    return loop


# K3 on the card: (layout, payload, dim, kf, the product loop the plan must
# pick) — the ring wherever a byte pool's pages make whole 128-column tiles
# (R divides 128, a multiple of 4, or 128 divides R) at whole 64-dim chunks;
# other pages and bf16 / fp32 pools keep the staged wgmma loop, dims off
# the 64-dim chunk mma.sync. Every layout has a chain ending on its first
# sub-block's boundary (an empty second sub-block), chains ending inside a
# tile (R < 128), tombstones and NaN rows past the chains.
K3_CARD_CASES = {
    "r128_uint8_kf10": ((128, 8, 4, 2), "uint8", 128, 10, "ring"),
    "r128_int8_kf20": ((128, 8, 4, 2), "int8", 128, 20, "ring"),
    "r128_uint8_kf129": ((128, 8, 4, 2), "uint8", 128, 129, "ring"),
    "r128_int8_kf512": ((128, 8, 4, 2), "int8", 128, 512, "ring"),
    "r64_uint8_dim64_kf40": ((64, 16, 8, 2), "uint8", 64, 40, "ring"),
    "r32_int8_kf1": ((32, 16, 8, 2), "int8", 128, 1, "ring"),
    "r24_uint8_kf20": ((24, 16, 8, 2), "uint8", 128, 20, "wgmma"),
    "r128_bf16_kf20": ((128, 8, 4, 2), "bf16", 128, 20, "wgmma"),
    "r64_fp32_dim64_kf10": ((64, 16, 8, 2), "fp32", 64, 10, "wgmma"),
    "r8_uint8_dim24_kf20": ("r8_w64_nsub2", "uint8", 24, 20, "mma.sync"),
    # a search filter's bias: whole dead lists, half the other rows dead
    "filtered_r128_uint8_kf10": ((128, 8, 4, 2), "uint8", 128, 10, "ring"),
    "filtered_r128_int8_kf20": ((128, 8, 4, 2), "int8", 128, 20, "ring"),
    "filtered_r64_bf16_kf40": ((64, 16, 8, 2), "bf16", 128, 40, "wgmma"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K3_CARD_CASES))
def test_k3_matches_plain_twin_on_card(case):
    """K3 against its plain twin on the card (runs where there is one), on
    each product loop, bit for bit (integer queries, integer or
    quarter-integer pages: every sum is exact), and the launch reports the
    loop its plan picks."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K3 is CUDA code with no CPU mode")
    layout, payload, dim, kf, loop = K3_CARD_CASES[case]
    rng = np.random.default_rng(31)
    c = paged_inputs(rng, layout, "fp32" if payload == "bf16" else payload,
                     dim=dim)
    if case.startswith("filtered"):
        c = _filtered(c, rng)
    c = _nan_past_chains(c)
    c["bf16"] = payload == "bf16"
    args = _cuda_args(c, torch.device("cuda"))
    static = (c["ppf"], c["n_sub"], c["R"], c["W"], -2.0, kf)
    assert _assert_matches_twin(args, static) == loop


@pytest.mark.cuda
def test_k3_on_card_after_an_upsert():
    """K3 on a 128-row uint8 pool, then on the same pool after an upsert
    (a list's chain takes a free page of fresh rows, another row becomes a
    tombstone): each launch matches the twin on the pool as it then stands."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K3 is CUDA code with no CPU mode")
    rng = np.random.default_rng(33)
    c = _nan_past_chains(paged_inputs(rng, (128, 8, 4, 2), "uint8",
                                      dim=128))
    static = (c["ppf"], c["n_sub"], c["R"], c["W"], -2.0, 10)
    dev = torch.device("cuda")
    assert _assert_matches_twin(_cuda_args(c, dev), static) == "ring"
    held = set(c["table"][c["table"] >= 0].tolist())
    free = next(i for i in range(1, c["pages"].shape[0]) if i not in held)
    c["pages"][free] = rng.integers(0, 256, c["pages"][free].shape)
    c["bias"][free] = rng.uniform(0.1, 900.0, c["bias"][free].shape)
    c["table"][2, c["chains"][2]] = free
    c["chains"][2] += 1
    c["bias"][c["table"][5, 0], 0] = np.inf
    assert _assert_matches_twin(_cuda_args(c, dev), static) == "ring"


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
    "filtered_nb16_kf80": ((128, 8, 4, 2), 1, 128, 80, "wgmma"),
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
    if case.startswith("filtered"):
        c = _filtered(c, rng)
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
