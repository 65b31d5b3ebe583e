"""The parity tail on an NVIDIA card: ``deep_like_rows`` on the card
against the CPU, the keyed sum's bits call to call, and a search planned
by the host planner against the device plan through K1. The tests carry
the ``cuda`` marker and skip without a card. This file imports neither
JAX nor the JAX package, so it runs where only PyTorch is installed:
``python -m pytest --noconftest -p no:cacheprovider -q
tests/test_torch_tail_card.py``."""

import numpy as np
import pytest
import torch

from raft_tpu_torch.bench.datasets import deep_like_rows
from raft_tpu_torch.ops import linalg
from raft_tpu_torch.ops import strip_scan as tss

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def test_deep_like_rows_agree_between_cpu_and_card(card):
    """Float64 maths on both: the CPU and the card agree to float32
    rounding (rtol 1e-6, atol 1e-7 for unit rows), and a row has the same
    bits alone as in a batch on the card."""
    ids = np.random.default_rng(1).integers(0, 2 ** 31 - 1, 20_000)
    cpu = deep_like_rows(ids, device="cpu")
    got = deep_like_rows(ids, device=card).cpu()
    np.testing.assert_allclose(got.numpy(), cpu.numpy(), rtol=1e-6,
                               atol=1e-7)
    alone = torch.cat([deep_like_rows(ids[j:j + 1], device=card)
                       for j in range(7)]).cpu()
    assert torch.equal(alone, got[:7])


def test_keyed_sum_is_the_same_bits_every_call_on_the_card(card):
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(200_000, 64, generator=gen, device=card)
    keys = torch.randint(-2, 300, (200_000,), generator=gen, device=card)
    first = linalg.reduce_rows_by_key(x, keys, 256)
    for _ in range(3):
        assert torch.equal(linalg.reduce_rows_by_key(x, keys, 256), first)
    ref = linalg.reduce_rows_by_key(x.cpu(), keys.cpu(), 256, device="cpu")
    np.testing.assert_allclose(first.cpu().numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_host_planned_k1_search_equals_the_device_plan(card):
    """Integer queries and uint8 lists (exact fp32 sums): the host plan's
    search and the device plan's give the same bits through K1, with one
    launch a class of the host plan per tile."""
    rng = np.random.default_rng(3)
    n_lists, m, dim = 16, 8192, 128
    lens = rng.integers(0, 3000, n_lists)
    lens[3], lens[5] = 0, 4500
    probes = np.where(rng.random((2000, 4)) < 0.5, 7,
                      rng.integers(0, n_lists, (2000, 4))).astype(np.int32)
    data = torch.from_numpy(rng.integers(0, 20, (n_lists, m, dim)).astype(
        np.uint8)).to(card)
    ids = torch.full((n_lists, m), -1, dtype=torch.int64)
    bias = torch.full((n_lists, m), float("inf"))
    for li in range(n_lists):
        ids[li, :lens[li]] = torch.arange(lens[li]) + li * m
        bias[li, :lens[li]] = torch.from_numpy(
            rng.integers(0, 50, lens[li]).astype(np.float32))
    ids, bias = ids.to(card), bias.to(card)
    q = torch.from_numpy(rng.integers(-4, 5, (2000, dim)).astype(
        np.float32)).to(card)
    pr = torch.from_numpy(probes).to(card)
    classes, cls_ord = tss.class_info(lens, dim)
    q_tile = tss.fit_q_tile(2000, 4, n_lists, len(classes), 10, 1 << 20,
                            dim=dim)
    plans = {"host": tss.host_plan(pr, lens, n_lists, dim),
             "device": lambda start, qt: tss.plan_tile(
                 pr, start, qt, torch.from_numpy(cls_ord).to(card), classes,
                 n_lists)}
    k1 = tss._k1_class_fn(data, bias, -2.0, 10, False)
    out = {}
    for planner, plan in plans.items():
        tss.STRIP_KERNEL.reset()
        out[planner] = tss._scan_tiles(q, pr, ids, 10, 10, q_tile, plan, k1)
        out[planner + "_launches"] = tss.STRIP_KERNEL.launches
    assert torch.equal(out["host"][0], out["device"][0])
    assert torch.equal(out["host"][1], out["device"][1])
    expected = sum(len(tss.plan_strips(probes[s:s + q_tile], lens, n_lists,
                                       dim).class_layout)
                   for s in range(0, 2000, q_tile))
    assert out["host_launches"] == out["device_launches"] == expected > 0
