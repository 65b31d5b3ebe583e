"""One fused CAGRA traversal hop (counterpart of ``raft_tpu/ops/cagra_hop.py``).

One iteration of the compressed best-first loop
(:func:`raft_tpu_torch.neighbors.cagra._search_impl_compressed`) is a parent
pickup and five tensor ops: a graph-row gather, a neighbour-code gather, an
int8 × bf16 contraction, an exact dedup and the itopk merge.
:func:`fused_hop` does the whole hop for every query in one launch of
kernel K6 (``csrc/cagra_hop.cu``) on a CUDA tensor, and in its plain twin
:func:`fused_hop_reference` on a CPU tensor:

* **pickup** (when no ``parents`` are given) — the best ``width``
  unvisited valid buffer slots by the packed select, marked visited
  (:func:`pick_parents`; the JAX package runs it outside its kernel,
  because the TPU's DMA engine needs parent ids as scalar-prefetch
  operands);
* **gather** — each query's parent graph rows and their inlined
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

Bounds: ids are int32 and every code-record address is computed in 64
bits, so the kernel takes any ``n`` below 2**31 (:data:`MAX_FUSED_ROWS`);
at 1M × 64 × 64 the codes are 4.2 GB, past 2**31 bytes. The TPU kernel's
2**24 came from its fp32 one-hot id extraction, which a CUDA gather does
not need. ``itopk + w·deg`` may be at most 2048 (:func:`hop_shape_error`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from raft_tpu_torch.ops import _native
from raft_tpu_torch.ops.select_k import _pack_bits_for, iter_topk_min_packed

# ids are int32; code-record offsets are 64-bit in the kernel
MAX_FUSED_ROWS = (1 << 31) - 1
MAX_MERGE_WIDTH = 2048          # itopk + w·deg: the launcher's kMaxMerge
SMEM_LIMIT = 227 * 1024         # the launcher's kSmemLimit, bytes per block
QUERIES_PER_BLOCK = 4           # the launcher's kWarpsPerBlock: a warp a query
HOP_KERNEL = _native.KernelCounter("cagra_hop")
_PLAIN_CHUNK_BYTES = 256 << 20  # the twin's rows·b·(b + itopk + 8p) per step


def hop_shape_error(n: int, itopk: int, w: int, deg: int, p: int) -> str:
    """Why K6 cannot take a hop of this shape, or "" when it can: ``n``
    past :data:`MAX_FUSED_ROWS`, ``itopk + w·deg`` past
    :data:`MAX_MERGE_WIDTH`, or one query's code records with the sort
    keys, qp, buffer row, candidate ids and parents past
    :data:`SMEM_LIMIT` (what one block staged when K6 ran a block a
    query). The warp-a-query kernel stages only its dedup table, keys and
    ids (at most 56 KB a query); the record bound stays so that every
    revision of K6 takes the same shapes."""
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


def _hop_width(buf_ids, parents, width) -> int:
    """The number of parents a hop expands: ``parents``' columns, or in the
    picking mode ``width`` capped at itopk (the packed select returns at
    most itopk slots)."""
    if parents is not None:
        return parents.shape[1]
    if width is None or int(width) < 1:
        raise ValueError("a hop without parents picks its own: give "
                         f"width ≥ 1, got {width}")
    return min(int(width), buf_ids.shape[1])


def _check_hop_args(buf_ids, buf_d, buf_vis, parents, qp, graph, nbr_codes,
                    w: int):
    q, itopk = buf_ids.shape
    n, deg = graph.shape
    p = qp.shape[1]
    for name, t in (("buf_d", buf_d), ("buf_vis", buf_vis)):
        if t.shape != buf_ids.shape:
            raise ValueError(f"{name} must be {tuple(buf_ids.shape)}, got "
                             f"{tuple(t.shape)}")
    if parents is not None and (parents.ndim != 2 or parents.shape[0] != q):
        raise ValueError("parents need one row per buffer row")
    if qp.shape[0] != q:
        raise ValueError("qp needs one row per buffer row")
    if tuple(nbr_codes.shape) != (n, deg, p):
        raise ValueError(f"nbr_codes must be {(n, deg, p)}, got "
                         f"{tuple(nbr_codes.shape)}")
    why = hop_shape_error(n, itopk, w, deg, p)
    if why:
        raise ValueError(why)


def pick_parents(buf_ids, buf_d, buf_vis, width: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hop's parent pickup in plain torch, as the JAX package's loop
    body runs it: the best ``width`` slots of ``pkey`` (+inf where visited
    or id -1) by the packed select over itopk columns, marked visited →
    (vis, parents (q, min(width, itopk)) int32, -1 where the picked value
    is ±inf)."""
    inf = float("inf")
    pkey = torch.where((buf_vis > 0) | (buf_ids < 0),
                       torch.full_like(buf_d, inf), buf_d)
    pv, ppos = iter_topk_min_packed(pkey, width)
    ppos = ppos.long()
    parent_ids = torch.gather(buf_ids, 1, ppos)
    parents = torch.where(torch.isinf(pv), torch.full_like(parent_ids, -1),
                          parent_ids)
    return buf_vis.scatter(1, ppos, 1.0), parents


def fused_hop_reference(buf_ids, buf_d, buf_vis, parents, qp, graph,
                        nbr_codes, width: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain twin of K6: without ``parents``, :func:`pick_parents` of
    ``width`` first; then op for op the JAX package's
    ``fused_hop_reference``: the unfused gather / contraction / dedup /
    merge, candidate duplicates masked before the select. Rows are taken in
    chunks so the (rows, b, b) compare stays bounded."""
    w = _hop_width(buf_ids, parents, width)
    _check_hop_args(buf_ids, buf_d, buf_vis, parents, qp, graph, nbr_codes, w)
    if parents is None:
        buf_vis, parents = pick_parents(buf_ids, buf_d, buf_vis, w)
    q, itopk = buf_ids.shape
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
    """K6's entry with the parents given (``raft_cagra_hop``)."""
    fn = _native.load("cagra_hop").raft_cagra_hop
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _pick_kernel_fn():
    """K6's picking entry (``raft_cagra_pick_hop``)."""
    fn = _native.load("cagra_hop").raft_cagra_pick_hop
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def check_hop_operands(buf_ids, buf_d, buf_vis, parents, qp, graph,
                       nbr_codes) -> None:
    """What the wrapper checks before a launch: one device, the kernel's
    dtypes, contiguous operands (``parents`` may be None: the picking
    mode). Raises on the first violation."""
    named = {"buf_ids": buf_ids, "buf_d": buf_d, "buf_vis": buf_vis,
             "parents": parents, "qp": qp, "graph": graph,
             "nbr_codes": nbr_codes}
    want = {"buf_ids": torch.int32, "buf_d": torch.float32,
            "buf_vis": torch.float32, "parents": torch.int32,
            "qp": torch.float32, "graph": torch.int32,
            "nbr_codes": torch.int8}
    for name, t in named.items():
        if t is None and name == "parents":
            continue
        if t.device != buf_ids.device:
            raise ValueError(f"{name} is on {t.device}, the buffer on "
                             f"{buf_ids.device}")
        if t.dtype != want[name]:
            raise TypeError(f"{name} must be {want[name]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _fused_hop_cuda(buf_ids, buf_d, buf_vis, parents, qp, graph, nbr_codes,
                    width):
    """Launch K6 (``csrc/cagra_hop.cu``) on the current stream: its
    picking entry without ``parents``, else the one that takes them."""
    w = _hop_width(buf_ids, parents, width)
    _check_hop_args(buf_ids, buf_d, buf_vis, parents, qp, graph, nbr_codes, w)
    check_hop_operands(buf_ids, buf_d, buf_vis, parents, qp, graph, nbr_codes)
    q, itopk = buf_ids.shape
    n, deg = graph.shape
    p = qp.shape[1]
    out_ids = torch.empty_like(buf_ids)
    out_d = torch.empty_like(buf_d)
    out_vis = torch.empty_like(buf_vis)
    if q == 0:
        return out_ids, out_d, out_vis
    stream = torch.cuda.current_stream(buf_ids.device).cuda_stream
    head = (buf_ids.data_ptr(), buf_d.data_ptr(), buf_vis.data_ptr())
    tail = (qp.data_ptr(), graph.data_ptr(), nbr_codes.data_ptr(),
            out_ids.data_ptr(), out_d.data_ptr(), out_vis.data_ptr(), q,
            itopk, w, n, deg, p, _pack_bits_for(itopk + w * deg))
    if parents is None:
        rc = _pick_kernel_fn()(*head, *tail, _pack_bits_for(itopk), stream)
    else:
        rc = _kernel_fn()(*head, parents.data_ptr(), *tail, stream)
    if rc != 0:
        raise RuntimeError(_native.launch_message("cagra_hop", rc))
    HOP_KERNEL.launches += 1
    return out_ids, out_d, out_vis


def fused_hop(buf_ids, buf_d, buf_vis, parents, qp, graph, nbr_codes,
              width: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused traversal hop for every query.

    buf_ids / buf_d / buf_vis: (q, itopk) int32 / fp32 / fp32, the
      candidate buffer (vis 1.0 at visited slots).
    parents: (q, w) int32 ids to expand (-1 = none, ids < n; their slots
      already marked visited), or None: the hop picks the best ``width``
      unvisited slots itself (:func:`pick_parents`) and marks them.
    qp: (q, p) fp32 queries in code units ((q @ proj) / code_scale).
    graph: (n, deg) int32; nbr_codes: (n, deg, p) int8.

    Returns the merged (ids, distances, vis). CUDA tensors launch kernel K6
    (a failed launch raises); CPU tensors take the plain twin."""
    if buf_ids.device.type == "cuda":
        return _fused_hop_cuda(buf_ids, buf_d, buf_vis, parents, qp, graph,
                               nbr_codes, width)
    return fused_hop_reference(buf_ids, buf_d, buf_vis, parents, qp, graph,
                               nbr_codes, width)


def launch_layout(itopk: int, width: int, degree: int) -> dict:
    """K6's launch for one hop shape, as its launcher computes it: one warp
    a query, the queries a block (4, fewer where their shared memory would
    not fit), each warp's shared bytes (the dedup table of 2^⌈log2(1.5·m)⌉
    8-byte slots, at least 32, beside the buffer row's keys, ids and flags,
    the candidates' ids and scores and the parents) and its widest register
    sort (32·K keys, K the least power of two with 32·K ≥ max(b, itopk);
    the candidates that can still enter the buffer take the least width
    that holds them)."""
    b = int(width) * int(degree)
    m = int(itopk) + b
    table = 1 << max(5, (m + m // 2 - 1).bit_length())
    warp_bytes = -(-(8 * table + 12 * itopk + 8 * b + 4 * width) // 16) * 16
    per_block = min(QUERIES_PER_BLOCK, SMEM_LIMIT // warp_bytes)
    keys = max(b, int(itopk))
    return {"warps_per_query": 1, "queries_per_block": per_block,
            "shared_bytes_per_warp": warp_bytes, "table_slots": table,
            "sort_width": 32 << max(0, (-(-keys // 32) - 1).bit_length())}


def occupancy_stats(q: int, q_block: int, width: int, degree: int,
                    proj_dim: int, itopk: int) -> dict:
    """Static shape diagnostics of one hop over ``q`` queries: the share of
    rows a ``q_block``-row grid would pad (the JAX package's TPU grid; K6
    pads nothing), candidates per query, the merge width, and K6's own
    layout (:func:`launch_layout`: a warp a query, queries a block, shared
    bytes a warp, its widest register sort)."""
    q_block = max(1, int(q_block))
    q_pad = -(-int(q) // q_block) * q_block
    b = int(width) * int(degree)
    layout = launch_layout(itopk, width, degree)
    return {
        "q": int(q),
        "q_pad": int(q_pad),
        "q_block": int(q_block),
        "padded_row_fraction": round(1.0 - q / q_pad, 4) if q_pad else 0.0,
        "candidates_per_query": b,
        "code_bytes_per_query": b * int(proj_dim),
        "merge_width": int(itopk) + b,
        "blocks": -(-int(q) // layout["queries_per_block"]),
        **layout,
    }
