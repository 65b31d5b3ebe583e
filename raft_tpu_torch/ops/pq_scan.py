"""The IVF-PQ lookup-table list scan (counterpart of ``raft_tpu/ops/pq_scan.py``).

The scan is list-centric, as in the JAX package: the queries probing one
list are grouped onto it (:func:`group_probed_pairs`), their LUT rows are
gathered per list by the caller, and every list is scored against its
grouped rows at once:

    out[l, i, j] = Σ_s luts_grouped[l, i, s·nc + codes_t[l, s, j]] + b_sum[l, j]

:func:`pq_scan` launches kernel K5 (``csrc/pq_scan.cu``, written by hand
for Hopper; its note says how it is tiled) on CUDA tensors and takes the
plain twin :func:`pq_scan_reference` only on CPU tensors. The TPU kernel's
one-hot block, built in VMEM to feed the matrix unit, does not carry over:
K5 gathers the LUT entries from shared memory. Neither the wrapper nor the
twin needs the TPU's ``m % 128`` or ``qpl % 16`` tiling; the pallas search
backend keeps ``max_list_size % 128 == 0`` as its eligibility rule.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from raft_tpu_torch.ops import _native

#: launches of the hand-written K5 kernel (``csrc/pq_scan.cu``)
PQ_KERNEL = _native.KernelCounter("pq_scan")
_PLAIN_CHUNK_BYTES = 256 << 20  # the twin's (lists, qpl, s, m) fp32 gather per step


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


def _kernel_fn():
    fn = _native.load("pq_scan").raft_pq_scan
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _pq_scan_cuda(luts_grouped, codes_t, b_sum, nc: int) -> torch.Tensor:
    """Launch K5 (``csrc/pq_scan.cu``) on the current stream."""
    _check_scan_args(luts_grouped, codes_t, b_sum, nc)
    for name, t in (("luts_grouped", luts_grouped), ("codes_t", codes_t),
                    ("b_sum", b_sum)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if luts_grouped.data_ptr() % 16:
        raise ValueError("luts_grouped must be 16-byte aligned")
    L, qpl, _ = luts_grouped.shape
    _, s, m = codes_t.shape
    if -(-qpl // 16) > 65535:
        raise ValueError(f"qpl {qpl} past the kernel's grid (16·65535)")
    out = torch.empty((L, qpl, m), dtype=torch.float32,
                      device=luts_grouped.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(luts_grouped.device).cuda_stream
    rc = _kernel_fn()(luts_grouped.data_ptr(), codes_t.data_ptr(),
                      b_sum.data_ptr(), out.data_ptr(), L, qpl, s, m, nc,
                      stream)
    if rc != 0:
        raise RuntimeError(f"pq_scan kernel launch failed: CUDA error {rc}")
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

    Returns (L, qpl, m) fp32 scores. CUDA tensors launch kernel K5 (a
    failed launch raises); CPU tensors take the plain twin."""
    if luts_grouped.device.type == "cuda":
        return _pq_scan_cuda(luts_grouped, codes_t, b_sum, nc)
    return pq_scan_reference(luts_grouped, codes_t, b_sum, nc)
