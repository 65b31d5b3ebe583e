"""Synthetic paged classes for the K3/K4 tests: numpy inputs shared by the
CPU parity tests (tests/test_torch_paged_scan.py, which also import JAX)
and the card tests (tests/test_torch_paged_card.py, which do not)."""

import numpy as np
import torch

from raft_tpu_torch.ops import strip_scan as tss

# name → (page_rows, table_width, ppf, n_sub)
LAYOUTS = {
    # 8-row pages, two sub-blocks of 8 pages (w = 64 < one 128-column tile)
    "r8_w64_nsub2": (8, 16, 8, 2),
    # 64-row pages, two sub-blocks of 2 pages (w = 128)
    "r64_w128_nsub2": (64, 4, 2, 2),
    # 32-row pages, one sub-block of 4 pages
    "r32_w128_nsub1": (32, 4, 4, 1),
    # the serving store's 128-row pages, two sub-blocks of 2 (w = 256):
    # chains of 1 and 3 pages end inside a sub-block
    "serve_r128_w256_nsub2": (128, 4, 2, 2),
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
