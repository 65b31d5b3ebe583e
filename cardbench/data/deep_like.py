"""DEEP-shaped unit rows, addressable by id, drawn on the device.

A frozen copy of ``raft_tpu_torch/bench/datasets.py`` ``deep_like_rows``
(commit c6c242d): row r is a pure function of ``(seed, r)``: a centre drawn
with Zipf(0.7) weights over ``n_coarse`` centres (N(0, 4) each), plus the
centre's spread (uniform in [0.5, 2.0]) times N(0, I), L2-normalised. The
uniforms come from a 32-bit counter hash on int64 tensors (CUDA torch has
no uint32 arithmetic), the normals from Box-Muller; the maths runs in
float64 and the row norm in a fixed order, so a row has the same bits
alone or in any batch. Unit rows match ``deep-image-96-angular``'s, on
which L2 ranks as the angular distance does. Rewritten to take no host
arrays: the cumulative centre weights are summed on the device. The
queries (:func:`deep_like_queries`, not in the original) are drawn from
the same mixture with a ``torch.Generator`` from the run's seed."""

from __future__ import annotations

import math

import torch

from cardbench.data import stratified

_M32 = 0xFFFFFFFF
#: bytes of float64 temporaries per chunk of rows
CHUNK_BYTES = 1 << 30


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for int64 h in [0, 2**32), without overflowing
    int64: the high 16 bits of h contribute only their product's low 16."""
    return ((((h >> 16) * c) & 0xFFFF) << 16) + (h & 0xFFFF) * c & _M32


def _fmix32(h):
    """A 32-bit avalanche finalizer (xorshift-multiply) on int64 tensors
    holding uint32 values, or on a python int."""
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


def _uniforms(counters: torch.Tensor, stream: int, width: int) -> torch.Tensor:
    """(len(counters), width) float64 uniforms in (0, 1), a pure function of
    (stream, counter, column): 24 hashed bits each."""
    base = _fmix32((counters & _M32) ^ stream)
    cols = torch.tensor([(j * 0x9E3779B9) & _M32 for j in range(width)],
                        dtype=torch.int64, device=counters.device)
    h = _fmix32(base[:, None] ^ cols[None, :])
    return ((h >> 8).to(torch.float64) + 0.5) * (1.0 / (1 << 24))


def _normals(u: torch.Tensor, dim: int) -> torch.Tensor:
    """``dim`` standard normals per row by Box-Muller from the row's uniform
    pairs (columns 2i, 2i + 1), in float64."""
    rad = torch.sqrt(-2.0 * torch.log(u[:, 0::2]))
    ang = (2.0 * math.pi) * u[:, 1::2]
    z = torch.stack([rad * torch.cos(ang), rad * torch.sin(ang)], dim=2)
    return z.reshape(u.shape[0], -1)[:, :dim]


def _row_norms(x: torch.Tensor) -> torch.Tensor:
    """L2 row norms summed in a fixed pairwise order."""
    w = 1 << max(0, math.ceil(math.log2(max(x.shape[1], 1))))
    sq = torch.nn.functional.pad(x * x, (0, w - x.shape[1]))
    while sq.shape[1] > 1:
        h = sq.shape[1] // 2
        sq = sq[:, :h] + sq[:, h:]
    return torch.sqrt(sq[:, 0])


def _mixture(dim: int, seed: int, n_coarse: int, dev):
    """(centres, spreads, weights) of the mixture of ``seed``."""
    s = _fmix32((int(seed) * 0x9E3779B9 + 0x7F4A7C15) & _M32)
    s_centres, s_spread = _fmix32(s ^ 0x85EBCA6B), _fmix32(s ^ 0xC2B2AE35)
    pairs = 2 * ((dim + 1) // 2)
    k = torch.arange(n_coarse, dtype=torch.int64, device=dev)
    centres = _normals(_uniforms(k, s_centres, pairs), dim) * 2.0
    spread = 0.5 + 1.5 * _uniforms(k, s_spread, 1)[:, 0]
    w = 1.0 / torch.arange(1, n_coarse + 1, dtype=torch.float64,
                           device=dev) ** 0.7
    return centres, spread, w / w.sum()


def _unit(rows: torch.Tensor) -> torch.Tensor:
    return (rows / torch.clamp(_row_norms(rows), min=1e-30)[:, None]).to(
        torch.float32)


def deep_like_rows(row_ids: torch.Tensor, dim: int, seed: int,
                   n_coarse: int = 4096) -> torch.Tensor:
    """float32 rows (len(row_ids), dim) on ``row_ids``' device."""
    dev = row_ids.device
    ids = row_ids.reshape(-1).to(torch.int64)
    s_rows = _fmix32((int(seed) * 0x9E3779B9 + 0x7F4A7C15) & _M32)
    pairs = 2 * ((dim + 1) // 2)
    centres, spread, w = _mixture(dim, seed, n_coarse, dev)
    cw = torch.cumsum(w, 0)
    out = torch.empty((ids.shape[0], dim), dtype=torch.float32, device=dev)
    step = max(1, CHUNK_BYTES // ((pairs + 1) * 8 * 8))
    for b in range(0, ids.shape[0], step):
        u = _uniforms(ids[b:b + step], s_rows, pairs + 1)
        c = torch.clamp(torch.searchsorted(cw, u[:, 0].contiguous()),
                        max=n_coarse - 1)
        out[b:b + step] = _unit(centres[c] + _normals(u[:, 1:], dim)
                                * spread[c][:, None])
    return out


def deep_like_queries(n_queries: int, dim: int, seed: int, query_seed: int,
                      device, n_coarse: int = 4096) -> torch.Tensor:
    """float32 unit queries (n_queries, dim) of the mixture of ``seed``,
    drawn from ``query_seed`` with each component as often whatever the
    seed (:func:`cardbench.data.stratified`)."""
    centres, spread, w = _mixture(dim, seed, n_coarse, device)
    g = torch.Generator(device=device)
    g.manual_seed(int(query_seed))
    c = stratified(w, n_queries, g)
    z = torch.randn(n_queries, dim, generator=g, dtype=torch.float64,
                    device=device)
    return _unit(centres[c] + z * spread[c][:, None])


def make(spec: dict, n_queries: int, query_seed: int, device):
    """(rows float32 (n, dim), queries float32 (n_queries, dim)) on
    ``device``: the rows are ids 0..n-1 of ``spec["seed"]``, so every run
    serves the same rows; the queries are fresh draws of the same mixture
    from ``query_seed`` (:func:`deep_like_queries`)."""
    n, dim = int(spec["rows"]), int(spec["dim"])
    rows = deep_like_rows(torch.arange(n, dtype=torch.int64, device=device),
                          dim, int(spec["seed"]))
    return rows, deep_like_queries(n_queries, dim, int(spec["seed"]),
                                   query_seed, device)
