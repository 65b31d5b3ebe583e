"""Benchmark datasets (counterpart of ``raft_tpu/bench/datasets.py``).

``sift_like`` is the JAX package's SIFT-shaped synthetic, generated by the
same numpy calls from the same seed, so both packages see the same rows.
The port keeps nothing on disk: the data is made anew on every call
(about half a minute at 1M × 128 on one core). :func:`data_dir` is where
real datasets are looked up (``bench/io.load_real_dataset``).

``deep_like_rows`` is row-addressable: row r is a pure function of
``(seed, r)``, made on the device from a counter-based hash. Torch cannot
replay ``jax.random``'s stream, so its rows are not the JAX package's;
they are the same mixture (Zipf(0.7)-weighted centres, spreads in [0.5,
2.0], L2-normalised) drawn from another stream."""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core.resources import (DeviceLike, Resources,
                                           resources_for, to_device)


def data_dir() -> str:
    """The dataset root: ``RAFT_TPU_DATA_DIR``, default
    ``~/.cache/raft_tpu_data`` — the one default every consumer (the bench
    runner's ``real`` datasets) resolves through, as in the JAX package."""
    return os.environ.get(
        "RAFT_TPU_DATA_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "raft_tpu_data"),
    )


def sift_like(n: int, dim: int = 128, n_queries: int = 10_000, seed: int = 0):
    """(dataset uint8 (n, dim), queries uint8 (n_queries, dim)): a two-level
    Zipf-weighted mixture with anisotropic clusters, mixed through a random
    basis with a decaying spectrum, rectified and clipped to uint8."""
    rng = np.random.default_rng(seed)
    n_coarse = max(64, min(4096, n // 256))
    total = n + n_queries

    w = 1.0 / np.arange(1, n_coarse + 1) ** 0.7
    w /= w.sum()
    assign = rng.choice(n_coarse, total, p=w)

    centers = rng.standard_normal((n_coarse, dim)).astype(np.float32) * 2.0
    spread = (0.5 + rng.random((n_coarse, dim)) * 1.5).astype(np.float32)

    x = centers[assign] + rng.standard_normal((total, dim)).astype(np.float32) \
        * spread[assign]

    basis = np.linalg.qr(rng.standard_normal((dim, dim)))[0].astype(np.float32)
    spectrum = (1.0 / np.sqrt(1.0 + np.arange(dim) / 8.0)).astype(np.float32)
    x = x @ (basis * spectrum[None, :])

    x = np.maximum(x, 0.0)
    scale = 110.0 / max(np.percentile(x, 99.5), 1e-6)
    x = np.clip(x * scale, 0, 255).astype(np.uint8)
    return x[:n], x[n:]


_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h · c) mod 2³² for int64 h in [0, 2³²): CUDA torch has no uint32
    arithmetic, and a full 32 × 32-bit product would overflow int64, so the
    high 16 bits of h contribute only their product's low 16 bits."""
    return ((((h >> 16) * c) & 0xFFFF) << 16) + (h & 0xFFFF) * c & _M32


def _fmix32(h):
    """A 32-bit avalanche finalizer (xorshift-multiply, "lowbias32") on
    int64 tensors holding uint32 values, or on a python int."""
    if isinstance(h, int):
        h ^= h >> 16
        h = (h * 0x7FEB352D) & _M32
        h ^= h >> 15
        h = (h * 0x846CA68B) & _M32
        return h ^ (h >> 16)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def _uniforms(counters: torch.Tensor, stream: int, width: int
              ) -> torch.Tensor:
    """(len(counters), width) float64 uniforms in (0, 1), a pure function
    of (stream, counter, column): 24 hashed bits each."""
    base = _fmix32((counters & _M32) ^ stream)
    cols = torch.tensor([(j * 0x9E3779B9) & _M32 for j in range(width)],
                        dtype=torch.int64, device=counters.device)
    h = _fmix32(base[:, None] ^ cols[None, :])
    return ((h >> 8).to(torch.float64) + 0.5) * (1.0 / (1 << 24))


def _normals(u: torch.Tensor, dim: int) -> torch.Tensor:
    """``dim`` standard normals per row by Box–Muller from the row's
    uniform pairs (columns 2i, 2i + 1), in float64."""
    rad = torch.sqrt(-2.0 * torch.log(u[:, 0::2]))
    ang = (2.0 * math.pi) * u[:, 1::2]
    z = torch.stack([rad * torch.cos(ang), rad * torch.sin(ang)], dim=2)
    return z.reshape(u.shape[0], -1)[:, :dim]


def _row_norms(x: torch.Tensor) -> torch.Tensor:
    """L2 row norms summed in a fixed pairwise order (the columns padded to
    a power of two, halved step by step), so a row's norm has the same bits
    alone or inside any batch."""
    w = 1 << max(0, math.ceil(math.log2(max(x.shape[1], 1))))
    sq = torch.nn.functional.pad(x * x, (0, w - x.shape[1]))
    while sq.shape[1] > 1:
        h = sq.shape[1] // 2
        sq = sq[:, :h] + sq[:, h:]
    return torch.sqrt(sq[:, 0])


def deep_like_rows(row_ids, dim: int = 96, seed: int = 0,
                   n_coarse: int = 4096,
                   device: Optional[DeviceLike] = None,
                   res: Optional[Resources] = None) -> torch.Tensor:
    """DEEP-shaped rows, addressable by id: row r is a pure function of
    ``(seed, r)``, so a 100M-row bench can stream build chunks and later
    regenerate exactly the rows exact re-ranking needs; the full matrix
    never exists anywhere.

    Row r: a centre c drawn with Zipf(0.7) weights over ``n_coarse``
    centres (N(0, 4) each), plus ``spread[c]``·N(0, I) with spreads uniform
    in [0.5, 2.0], L2-normalised → float32 of shape ``row_ids.shape +
    (dim,)`` on the resolved device (ids taken modulo 2³², a superset of
    the JAX package's int32 ids). The uniforms come from a 32-bit
    counter hash on int64 tensors, the normals from Box–Muller; the maths
    runs in float64 and the row norm in a fixed order, so a row has the
    same bits alone or in any batch, and the CPU and the card agree to
    float32 rounding. Rows are made in batches of at most
    ``res.workspace_bytes`` of temporaries."""
    res = resources_for(device, res)
    dev = res.device
    ids = to_device(row_ids, dev)
    shape = tuple(ids.shape)
    ids = ids.reshape(-1).to(torch.int64)
    s = _fmix32((int(seed) * 0x9E3779B9 + 0x7F4A7C15) & _M32)
    s_rows, s_centres, s_spread = s, _fmix32(s ^ 0x85EBCA6B), \
        _fmix32(s ^ 0xC2B2AE35)
    pairs = 2 * ((dim + 1) // 2)
    k = torch.arange(n_coarse, dtype=torch.int64, device=dev)
    centres = _normals(_uniforms(k, s_centres, pairs), dim) * 2.0
    spread = 0.5 + 1.5 * _uniforms(k, s_spread, 1)[:, 0]
    w = 1.0 / np.arange(1, n_coarse + 1, dtype=np.float64) ** 0.7
    cw = torch.from_numpy(np.cumsum(w / w.sum())).to(dev)
    step = max(1, int(res.workspace_bytes) // ((pairs + 1) * 8 * 8))
    out = []
    for b in range(0, ids.shape[0], step):
        u = _uniforms(ids[b:b + step], s_rows, pairs + 1)
        c = torch.clamp(torch.searchsorted(cw, u[:, 0].contiguous()),
                        max=n_coarse - 1)
        rows = centres[c] + _normals(u[:, 1:], dim) * spread[c][:, None]
        rows = rows / torch.clamp(_row_norms(rows), min=1e-30)[:, None]
        out.append(rows.to(torch.float32))
    rows = torch.cat(out) if out else torch.zeros((0, dim), device=dev)
    return rows.reshape(shape + (dim,))
