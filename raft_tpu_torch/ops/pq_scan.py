"""The IVF-PQ lookup-table list scan (counterpart of ``raft_tpu/ops/pq_scan.py``).

The scan is list-centric, as in the JAX package: every probed (query,
list) pair is scored against all entries of its list,

    score[pair, j] = Σ_s luts[lut_row, s·nc + codes_t[list, s, j]] + b_sum[list, j]

Kernel K5 (``csrc/pq_scan.cu``, written by hand for Hopper; its note says
how it is tiled) takes the pairs themselves: each pair's LUT row in a
per-query table, its list and its output row, sorted by list. Two entries
launch it on CUDA tensors and take a plain twin only on CPU tensors:

* :func:`pq_scan_pairs` (twin :func:`pq_scan_pairs_reference`), which the
  pallas search backend calls with a query tile's probed pairs: no per-list
  cap, no dropped pair, no grouped LUT block;
* :func:`pq_scan` (twin :func:`pq_scan_reference`), the JAX package's
  grouped entry — (lists, slots, ·) blocks whose slot (l, i) is a pair
  with LUT row l·qpl + i — which runs the same K5 with that trivial pair
  list. :func:`group_probed_pairs` builds such blocks as the JAX package
  does.

The TPU kernel's one-hot block, built in VMEM to feed the matrix unit, does
not carry over: K5 gathers the LUT entries from shared memory. Neither
entry needs the TPU's ``m % 128`` or ``qpl % 16`` tiling; the pallas
search backend keeps ``max_list_size % 128 == 0`` as its eligibility rule.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from raft_tpu_torch.ops import _native

#: launches of the hand-written K5 kernel (``csrc/pq_scan.cu``)
PQ_KERNEL = _native.KernelCounter("pq_scan")
_PLAIN_CHUNK_BYTES = 256 << 20  # the twins' (·, s, m) fp32 gather per step
PAIRS_PER_BLOCK = 16            # K5's slots per block (kQB in pq_scan.cu)


def group_probed_pairs(probes: torch.Tensor, n_lists: int, qpl_cap: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invert the (query, probe) → list relation.

    probes: (q, p) list ids. Returns ``qids`` (n_lists, qpl_cap) int32, the
    queries probing each list in (query, probe) order, -1 padded; and
    ``slot`` (q, p) int32, each pair's position in its list's row, -1 where
    the pair ranks at or past ``qpl_cap`` and is dropped. Bit for bit the
    JAX package's grouping, drops included."""
    q, p = probes.shape
    flat = probes.reshape(-1).to(torch.int64)
    order = torch.argsort(flat, stable=True)
    sorted_lists = flat[order]
    sizes = torch.bincount(flat, minlength=n_lists)
    offsets = torch.cumsum(sizes, 0) - sizes
    rank = torch.arange(q * p, device=probes.device) - offsets[sorted_lists]
    keep = rank < qpl_cap
    qids = torch.full((n_lists, qpl_cap), -1, dtype=torch.int32,
                      device=probes.device)
    qids[sorted_lists[keep], rank[keep]] = (order[keep] // p).to(torch.int32)
    slot = torch.full((q * p,), -1, dtype=torch.int32, device=probes.device)
    slot[order] = torch.where(keep, rank, -1).to(torch.int32)
    return qids, slot.reshape(q, p)


def _check_scan_args(luts_grouped, codes_t, b_sum, nc: int) -> None:
    """Shapes and dtypes the kernel and its twin take; raises on the first
    violation."""
    if luts_grouped.ndim != 3 or codes_t.ndim != 3 or b_sum.ndim != 2:
        raise ValueError("pq_scan takes luts (L, qpl, s·nc), codes_t "
                         "(L, s, m) and b_sum (L, m)")
    L, qpl, f = luts_grouped.shape
    _, s, m = codes_t.shape
    if nc < 16 or nc > 256 or nc & (nc - 1):
        raise ValueError(f"nc must be a power of two in [16, 256], got {nc}")
    if f != s * nc or codes_t.shape[0] != L or tuple(b_sum.shape) != (L, m):
        raise ValueError(f"inconsistent shapes: luts {tuple(luts_grouped.shape)}"
                         f", codes_t {tuple(codes_t.shape)}, b_sum "
                         f"{tuple(b_sum.shape)}, nc {nc}")
    want = ((luts_grouped, torch.bfloat16, "luts_grouped"),
            (codes_t, torch.uint8, "codes_t"), (b_sum, torch.float32, "b_sum"))
    for t, dtype, name in want:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != luts_grouped.device:
            raise ValueError(f"{name} is on {t.device}, luts_grouped on "
                             f"{luts_grouped.device}")


def pq_scan_reference(luts_grouped, codes_t, b_sum, nc: int) -> torch.Tensor:
    """The plain twin of K5: per list, gather each slot's LUT entry of
    every (subspace, entry) in fp32, sum over subspaces, add ``b_sum``.
    Lists are taken in chunks so the (lists, qpl, s, m) fp32 gather stays
    under :data:`_PLAIN_CHUNK_BYTES`."""
    _check_scan_args(luts_grouped, codes_t, b_sum, nc)
    L, qpl, f = luts_grouped.shape
    _, s, m = codes_t.shape
    out = torch.empty((L, qpl, m), dtype=torch.float32,
                      device=luts_grouped.device)
    s_off = (torch.arange(s, device=codes_t.device) * nc)[None, :, None]
    step = max(1, _PLAIN_CHUNK_BYTES // max(1, qpl * s * m * 4))
    for a in range(0, L, step):
        b = min(L, a + step)
        idx = (codes_t[a:b].to(torch.int64) + s_off).reshape(b - a, 1, s * m)
        picked = torch.gather(luts_grouped[a:b].to(torch.float32), 2,
                              idx.expand(b - a, qpl, s * m))
        out[a:b] = picked.reshape(b - a, qpl, s, m).sum(2) + b_sum[a:b, None, :]
    return out


def _check_pair_args(luts, pair_lut, pair_list, pair_out, codes_t, b_sum,
                     nc: int) -> None:
    """Shapes and dtypes :func:`pq_scan_pairs` and its twin take; raises
    on the first violation."""
    if luts.ndim != 2 or codes_t.ndim != 3 or b_sum.ndim != 2:
        raise ValueError("pq_scan_pairs takes luts (rows, s·nc), codes_t "
                         "(L, s, m) and b_sum (L, m)")
    L, s, m = codes_t.shape
    if nc < 16 or nc > 256 or nc & (nc - 1):
        raise ValueError(f"nc must be a power of two in [16, 256], got {nc}")
    if luts.shape[1] != s * nc or tuple(b_sum.shape) != (L, m):
        raise ValueError(f"inconsistent shapes: luts {tuple(luts.shape)}, "
                         f"codes_t {tuple(codes_t.shape)}, b_sum "
                         f"{tuple(b_sum.shape)}, nc {nc}")
    n = pair_lut.shape[0]
    for t, name in ((pair_lut, "pair_lut"), (pair_list, "pair_list"),
                    (pair_out, "pair_out")):
        if t.ndim != 1 or t.shape[0] != n:
            raise ValueError(f"{name} must be ({n},), got {tuple(t.shape)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32, got {t.dtype}")
    want = ((luts, torch.bfloat16, "luts"), (codes_t, torch.uint8, "codes_t"),
            (b_sum, torch.float32, "b_sum"))
    for t, dtype, name in want:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    for t, name in ((pair_lut, "pair_lut"), (pair_list, "pair_list"),
                    (pair_out, "pair_out"), (codes_t, "codes_t"),
                    (b_sum, "b_sum")):
        if t.device != luts.device:
            raise ValueError(f"{name} is on {t.device}, luts on {luts.device}")


def pq_scan_pairs_reference(luts, pair_lut, pair_list, pair_out, codes_t,
                            b_sum, nc: int) -> torch.Tensor:
    """The plain twin of :func:`pq_scan_pairs`: for every pair, the LUT
    entry of each (subspace, entry) of its list gathered in fp32 from its
    LUT row, summed over subspaces, ``b_sum`` added; written to the pair's
    output row. Pairs are taken in chunks so the (pairs, s, m) fp32 gather
    stays under :data:`_PLAIN_CHUNK_BYTES`."""
    _check_pair_args(luts, pair_lut, pair_list, pair_out, codes_t, b_sum, nc)
    _, s, m = codes_t.shape
    n = pair_lut.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=luts.device)
    s_off = (torch.arange(s, device=codes_t.device) * nc)[None, :, None]
    step = max(1, _PLAIN_CHUNK_BYTES // max(1, s * m * 4))
    for a in range(0, n, step):
        b = min(n, a + step)
        lists = pair_list[a:b].to(torch.int64)
        idx = (codes_t[lists].to(torch.int64) + s_off).reshape(b - a, s * m)
        picked = torch.gather(luts[pair_lut[a:b].to(torch.int64)].to(
            torch.float32), 1, idx)
        out[pair_out[a:b].to(torch.int64)] = (
            picked.reshape(b - a, s, m).sum(1) + b_sum[lists])
    return out


def pair_blocks(pair_list: torch.Tensor, n_lists: int) -> torch.Tensor:
    """K5's block table for pairs sorted by list: (n_blocks, 3) int32 rows
    (list, first pair, pairs ≤ 16), every list's pairs cut into runs of
    :data:`PAIRS_PER_BLOCK`. Built on the device with no host sync: the
    table has the static length ceil(P/16) + min(n_lists, P), and the rows
    past the real blocks hold 0 pairs (their blocks return at once)."""
    n = pair_list.shape[0]
    dev = pair_list.device
    lists = pair_list.to(torch.int64)
    sizes = torch.bincount(lists, minlength=n_lists)
    offsets = torch.cumsum(sizes, 0) - sizes
    nblk = (sizes + PAIRS_PER_BLOCK - 1) // PAIRS_PER_BLOCK
    cum = torch.cumsum(nblk, 0)
    n_rows = -(-n // PAIRS_PER_BLOCK) + min(n_lists, n)
    b = torch.arange(n_rows, device=dev)
    lst = torch.searchsorted(cum, b, right=True).clamp(max=n_lists - 1)
    j = b - (cum[lst] - nblk[lst])
    count = torch.where(b < cum[-1], torch.clamp(
        sizes[lst] - PAIRS_PER_BLOCK * j, max=PAIRS_PER_BLOCK), 0)
    return torch.stack([lst, offsets[lst] + PAIRS_PER_BLOCK * j, count],
                       1).to(torch.int32).contiguous()


def _kernel_fn():
    fn = _native.load("pq_scan").raft_pq_scan
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _pq_scan_cuda(luts, pair_lut, pair_out, blocks, codes_t, b_sum,
                  nc: int) -> torch.Tensor:
    """Launch K5 (``csrc/pq_scan.cu``) on the current stream over the block
    table ``blocks`` → (pairs, m) fp32 scores, one row per pair."""
    for name, t in (("luts", luts), ("pair_lut", pair_lut),
                    ("pair_out", pair_out), ("blocks", blocks),
                    ("codes_t", codes_t), ("b_sum", b_sum)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if luts.data_ptr() % 16:
        raise ValueError("luts must be 16-byte aligned")
    _, s, m = codes_t.shape
    n_blocks = blocks.shape[0]
    out = torch.empty((pair_lut.shape[0], m), dtype=torch.float32,
                      device=luts.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(luts.device).cuda_stream
    rc = _kernel_fn()(luts.data_ptr(), pair_lut.data_ptr(),
                      pair_out.data_ptr(), blocks.data_ptr(),
                      codes_t.data_ptr(), b_sum.data_ptr(), out.data_ptr(),
                      n_blocks, s, m, nc, stream)
    if rc != 0:
        raise RuntimeError(_native.launch_message("pq_scan", rc))
    PQ_KERNEL.launches += 1
    return out


def pq_scan(luts_grouped, codes_t, b_sum, nc: int) -> torch.Tensor:
    """Scan every list against its grouped queries.

    luts_grouped: (L, qpl, s·nc) bf16 — per-list LUT rows (gathered by the
      caller through ``qids`` of :func:`group_probed_pairs`; pad rows are
      zeros, and come out as exactly ``b_sum``).
    codes_t: (L, s, m) uint8 — codes with the list dimension minor.
    b_sum: (L, m) fp32 — per-entry list-side constant, +inf at padding.
    nc: codes per subspace, 2**pq_bits (16…256).

    Returns (L, qpl, m) fp32 scores. CUDA tensors launch kernel K5 with
    the trivial pair list, slot (l, i) the pair of LUT row and output row
    l·qpl + i (a failed launch raises); CPU tensors take the plain twin."""
    _check_scan_args(luts_grouped, codes_t, b_sum, nc)
    if luts_grouped.device.type == "cuda":
        L, qpl, f = luts_grouped.shape
        rows = torch.arange(L * qpl, dtype=torch.int32,
                            device=luts_grouped.device)
        lists = torch.div(rows, qpl, rounding_mode="floor")
        return _pq_scan_cuda(luts_grouped.reshape(L * qpl, f), rows, rows,
                             pair_blocks(lists, L), codes_t, b_sum,
                             nc).reshape(L, qpl, -1)
    return pq_scan_reference(luts_grouped, codes_t, b_sum, nc)


def pq_scan_pairs(luts, pair_lut, pair_list, pair_out, codes_t, b_sum,
                  nc: int) -> torch.Tensor:
    """Score probed (query, list) pairs against their lists' entries.

    luts: (rows, s·nc) bf16 — one LUT row per query (a tile's table as it
      is, no gather).
    pair_lut, pair_list, pair_out: (P,) int32 — each pair's LUT row, list
      and output row, the pairs sorted by list (stable: the order of
      :func:`group_probed_pairs`); ``pair_out`` is a permutation of
      0..P-1.
    codes_t: (L, s, m) uint8; b_sum: (L, m) fp32, +inf at padding.
    nc: codes per subspace, 2**pq_bits (16…256).

    Returns (P, m) fp32: row ``pair_out[i]`` holds pair i's scores. CUDA
    tensors launch kernel K5 (a failed launch raises); CPU tensors take
    the plain twin."""
    _check_pair_args(luts, pair_lut, pair_list, pair_out, codes_t, b_sum, nc)
    if luts.device.type == "cuda":
        return _pq_scan_cuda(luts, pair_lut, pair_out,
                             pair_blocks(pair_list, codes_t.shape[0]),
                             codes_t, b_sum, nc)
    return pq_scan_pairs_reference(luts, pair_lut, pair_list, pair_out,
                                   codes_t, b_sum, nc)
