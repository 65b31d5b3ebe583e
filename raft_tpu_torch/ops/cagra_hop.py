"""One fused CAGRA traversal hop (counterpart of ``raft_tpu/ops/cagra_hop.py``).

One iteration of the compressed best-first loop
(:func:`raft_tpu_torch.neighbors.cagra._search_impl_compressed`) is five
tensor ops: a graph-row gather, a neighbour-code gather, an int8 × bf16
contraction, an exact dedup and the itopk merge. :func:`fused_hop` does the
whole hop for every query in one launch of kernel K6
(``csrc/cagra_hop.cu``) on a CUDA tensor, and in its plain twin
:func:`fused_hop_reference` on a CPU tensor:

* **gather** — each query's ``width`` parent graph rows and their inlined
  ``(deg, p)`` int8 code records;
* **distance** — ``‖c‖² − 2⟨qp, c⟩`` in code units: ``ip`` sums
  ``bf16(c)·bf16(qp)`` and ``nrm`` sums ``c·c``, both in fp32;
* **dedup** — a candidate is +inf when its id is -1 (a -1 edge or an
  invalid parent), when it matches any buffer id, or when it matches an
  earlier candidate;
* **merge** — the mantissa-packed select
  (:func:`raft_tpu_torch.ops.select_k.iter_topk_min_packed`) over
  ``[buffer ‖ candidates]``: the column rides the low
  ⌈log2(itopk + w·deg)⌉ mantissa bits, so every hop re-packs the kept
  buffer values; ids are -1 where the value is +inf, ``vis`` comes from
  the buffer side and is 0 for candidates.

Parent selection (the best ``width`` unvisited slots) stays in the caller's
loop body, as in the JAX package.

Bounds: ids are int32 and every code-record address is computed in 64
bits, so the kernel takes any ``n`` below 2**31 (:data:`MAX_FUSED_ROWS`);
at 1M × 64 × 64 the codes are 4.2 GB, past 2**31 bytes. The TPU kernel's
2**24 came from its fp32 one-hot id extraction, which a CUDA gather does
not need. ``itopk + w·deg`` may be at most 2048 (the kernel's sort width)
and the staged records must fit the card's shared memory
(:func:`hop_shape_error`).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from raft_tpu_torch.ops import _native
from raft_tpu_torch.ops.select_k import _pack_bits_for, iter_topk_min_packed

# ids are int32; code-record offsets are 64-bit in the kernel
MAX_FUSED_ROWS = (1 << 31) - 1
MAX_MERGE_WIDTH = 2048          # itopk + w·deg: the kernel's bitonic width
SMEM_LIMIT = 227 * 1024         # the launcher's kSmemLimit, bytes per block
HOP_KERNEL = _native.KernelCounter("cagra_hop")
_PLAIN_CHUNK_BYTES = 256 << 20  # the twin's rows·b·(b + itopk + 8p) per step


def hop_shape_error(n: int, itopk: int, w: int, deg: int, p: int) -> str:
    """Why K6 cannot take a hop of this shape, or "" when it can: ``n``
    past :data:`MAX_FUSED_ROWS`, ``itopk + w·deg`` past
    :data:`MAX_MERGE_WIDTH`, or one block's staging (code records, sort
    keys, qp, buffer row, candidate ids, parents; the launcher's own sum)
    past :data:`SMEM_LIMIT`."""
    b = w * deg
    if n > MAX_FUSED_ROWS:
        return f"the hop takes at most {MAX_FUSED_ROWS} rows, got {n}"
    if itopk + b > MAX_MERGE_WIDTH:
        return (f"itopk + width·degree = {itopk + b} must be ≤ "
                f"{MAX_MERGE_WIDTH}")
    npad = 1 << max(1, (itopk + b - 1).bit_length())
    staged = (-(-b * p // 16) * 16 + npad * 8 + p * 4 + itopk * 12 + b * 4
              + w * 4)
    if staged > SMEM_LIMIT:
        return (f"one query's hop stages {staged} bytes, over the "
                f"{SMEM_LIMIT} of shared memory a block may hold")
    return ""


def _check_hop_args(buf_ids, buf_d, buf_vis, parents, qp, graph, nbr_codes):
    q, itopk = buf_ids.shape
    n, deg = graph.shape
    p = qp.shape[1]
    for name, t in (("buf_d", buf_d), ("buf_vis", buf_vis)):
        if t.shape != buf_ids.shape:
            raise ValueError(f"{name} must be {tuple(buf_ids.shape)}, got "
                             f"{tuple(t.shape)}")
    if parents.ndim != 2 or parents.shape[0] != q or qp.shape[0] != q:
        raise ValueError("parents and qp need one row per buffer row")
    if tuple(nbr_codes.shape) != (n, deg, p):
        raise ValueError(f"nbr_codes must be {(n, deg, p)}, got "
                         f"{tuple(nbr_codes.shape)}")
    why = hop_shape_error(n, itopk, parents.shape[1], deg, p)
    if why:
        raise ValueError(why)


def fused_hop_reference(buf_ids, buf_d, buf_vis, parents, qp, graph,
                        nbr_codes) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """The plain twin of K6, op for op the JAX package's
    ``fused_hop_reference``: the unfused gather / contraction / dedup /
    merge, candidate duplicates masked before the select. Rows are taken in
    chunks so the (rows, b, b) compare stays bounded."""
    _check_hop_args(buf_ids, buf_d, buf_vis, parents, qp, graph, nbr_codes)
    q, itopk = buf_ids.shape
    w = parents.shape[1]
    deg = graph.shape[1]
    p = qp.shape[1]
    b = w * deg
    step = max(1, _PLAIN_CHUNK_BYTES // max(1, b * (b + itopk + 8 * p)))
    tri = torch.tril(torch.ones((b, b), dtype=torch.bool,
                                device=buf_ids.device), diagonal=-1)
    outs = []
    for s in range(0, q, step):
        par = parents[s:s + step]
        bids = buf_ids[s:s + step]
        r = par.shape[0]
        pid = torch.clamp(par, min=0).long()
        gr = graph[pid]                                   # (r, w, deg)
        codes = nbr_codes[pid].reshape(r, b, p)
        nbrs = torch.where((par >= 0)[:, :, None] & (gr >= 0), gr,
                           torch.full_like(gr, -1)).reshape(r, b)
        cf = codes.to(torch.float32)     # int8 is exact in bf16
        qb = qp[s:s + step].to(torch.bfloat16).to(torch.float32)
        ip = torch.bmm(cf, qb[:, :, None])[:, :, 0]
        nrm = torch.sum(cf * cf, dim=2)
        inf = torch.full_like(nrm, float("inf"))
        cd = torch.where(nbrs >= 0, nrm - 2.0 * ip, inf)
        dup_buf = (nbrs[:, :, None] == bids[:, None, :]).any(dim=2)
        dup_self = ((nbrs[:, :, None] == nbrs[:, None, :]) & tri).any(dim=2)
        cd = torch.where(dup_buf | dup_self | (nbrs < 0), inf, cd)
        allv = torch.cat([buf_d[s:s + step], cd], dim=1)
        alli = torch.cat([bids, nbrs], dim=1)
        allvis = torch.cat([buf_vis[s:s + step], torch.zeros_like(cd)], dim=1)
        nv, sel = iter_topk_min_packed(allv, itopk)
        sel = sel.long()
        ni = torch.gather(alli, 1, sel)
        outs.append((torch.where(torch.isinf(nv), torch.full_like(ni, -1), ni),
                     nv, torch.gather(allvis, 1, sel)))
    if not outs:
        return buf_ids.clone(), buf_d.clone(), buf_vis.clone()
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


def _kernel_fn():
    fn = _native.load("cagra_hop").raft_cagra_hop
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def check_hop_operands(buf_ids, buf_d, buf_vis, parents, qp, graph,
                       nbr_codes) -> None:
    """What the wrapper checks before a launch: one device, the kernel's
    dtypes, contiguous operands. Raises on the first violation."""
    named = {"buf_ids": buf_ids, "buf_d": buf_d, "buf_vis": buf_vis,
             "parents": parents, "qp": qp, "graph": graph,
             "nbr_codes": nbr_codes}
    want = {"buf_ids": torch.int32, "buf_d": torch.float32,
            "buf_vis": torch.float32, "parents": torch.int32,
            "qp": torch.float32, "graph": torch.int32,
            "nbr_codes": torch.int8}
    for name, t in named.items():
        if t.device != buf_ids.device:
            raise ValueError(f"{name} is on {t.device}, the buffer on "
                             f"{buf_ids.device}")
        if t.dtype != want[name]:
            raise TypeError(f"{name} must be {want[name]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _fused_hop_cuda(buf_ids, buf_d, buf_vis, parents, qp, graph, nbr_codes):
    """Launch K6 (``csrc/cagra_hop.cu``) on the current stream."""
    _check_hop_args(buf_ids, buf_d, buf_vis, parents, qp, graph, nbr_codes)
    check_hop_operands(buf_ids, buf_d, buf_vis, parents, qp, graph, nbr_codes)
    q, itopk = buf_ids.shape
    w = parents.shape[1]
    n, deg = graph.shape
    p = qp.shape[1]
    out_ids = torch.empty_like(buf_ids)
    out_d = torch.empty_like(buf_d)
    out_vis = torch.empty_like(buf_vis)
    if q == 0:
        return out_ids, out_d, out_vis
    stream = torch.cuda.current_stream(buf_ids.device).cuda_stream
    rc = _kernel_fn()(buf_ids.data_ptr(), buf_d.data_ptr(), buf_vis.data_ptr(),
                      parents.data_ptr(), qp.data_ptr(), graph.data_ptr(),
                      nbr_codes.data_ptr(), out_ids.data_ptr(),
                      out_d.data_ptr(), out_vis.data_ptr(), q, itopk, w, n,
                      deg, p, _pack_bits_for(itopk + w * deg), stream)
    if rc != 0:
        raise RuntimeError(f"cagra_hop kernel launch failed: CUDA error {rc}")
    HOP_KERNEL.launches += 1
    return out_ids, out_d, out_vis


def fused_hop(buf_ids, buf_d, buf_vis, parents, qp, graph, nbr_codes
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused traversal hop for every query.

    buf_ids / buf_d / buf_vis: (q, itopk) int32 / fp32 / fp32, the
      candidate buffer (vis 1.0 at visited slots; parents already marked).
    parents: (q, w) int32 ids to expand, -1 = no parent. Ids must be < n.
    qp: (q, p) fp32 queries in code units ((q @ proj) / code_scale).
    graph: (n, deg) int32; nbr_codes: (n, deg, p) int8.

    Returns the merged (ids, distances, vis). CUDA tensors launch kernel K6
    (a failed launch raises); CPU tensors take the plain twin."""
    if buf_ids.device.type == "cuda":
        return _fused_hop_cuda(buf_ids, buf_d, buf_vis, parents, qp, graph,
                               nbr_codes)
    return fused_hop_reference(buf_ids, buf_d, buf_vis, parents, qp, graph,
                               nbr_codes)


def occupancy_stats(q: int, q_block: int, width: int, degree: int,
                    proj_dim: int, itopk: int) -> dict:
    """Static shape diagnostics of one hop over ``q`` queries: the share of
    rows a ``q_block``-row grid would pad (the JAX package's TPU grid; K6
    runs one block per query and pads nothing), candidates per query and the
    merge width the kernel sorts."""
    q_block = max(1, int(q_block))
    q_pad = -(-int(q) // q_block) * q_block
    b = int(width) * int(degree)
    merge = int(itopk) + b
    return {
        "q": int(q),
        "q_pad": int(q_pad),
        "q_block": int(q_block),
        "padded_row_fraction": round(1.0 - q / q_pad, 4) if q_pad else 0.0,
        "candidates_per_query": b,
        "code_bytes_per_query": b * int(proj_dim),
        "merge_width": merge,
        "sort_width": 1 << max(0, (merge - 1).bit_length()),
    }
