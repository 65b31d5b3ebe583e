"""Packed 1-bit (RaBitQ-style) list scan, the IVF-BQ search engine
(counterpart of ``raft_tpu/ops/bq_scan.py``).

The scan scores ``alpha·⟨q_rot, ±1⟩·scale + bias`` per probed list entry:
the stored codes stay ``bits·rot_dim/8`` bytes per row, and the ±1
expansion happens inside kernel K2 (``csrc/bq_scan.cu``), launched by
:func:`bq_class` for CUDA tensors. Its plain twin :func:`_bq_class_plain`
computes the same function with PyTorch ops and is what :func:`bq_class`
runs for CPU tensors. Everything around the per-class call (plan, query
grouping, tournament rule, sub-block merge, candidate merge) is
:mod:`raft_tpu_torch.ops.strip_scan`'s.

The paged half (serving) scans a ``PagedListStore``'s code, scale and
bias pools in place through kernel K4 (``csrc/paged_bq_scan.cu``),
launched by :func:`paged_bq_class`, on strip_scan's paged plan and merge;
its plain twin is :func:`_paged_bq_class_plain`.

Bit layout: rotated dimension ``d`` lives at bit ``d // nb`` of byte
``d % nb`` (``nb = rot_dim // 8``), bit-plane-major. Multi-bit codes
(2–4 bits) stack one such packed group per bit-plane, so an unpacked row
of ``NB = bits·nb`` bytes has column ``j·NB + r`` = bit j of byte r, and
:func:`extend_query_planes` orders and weights the query to match:
``⟨ext(q), ±1-planes⟩ == ⟨q, levels⟩`` exactly.
"""

from __future__ import annotations

import ctypes

import torch

from raft_tpu_torch.ops import _native
from raft_tpu_torch.ops import strip_scan as ss

#: launches of the hand-written K2 kernel (``csrc/bq_scan.cu``)
BQ_KERNEL = _native.KernelCounter("bq_scan")
#: launches of the hand-written K4 kernel (``csrc/paged_bq_scan.cu``)
PAGED_BQ_KERNEL = _native.KernelCounter("paged_bq_scan")


def packed_width(rot_dim: int) -> int:
    """Bytes per 1-bit-encoded row (rot_dim must be a multiple of 8)."""
    if rot_dim % 8:
        raise ValueError(f"rot_dim must be a multiple of 8, got {rot_dim}")
    return rot_dim // 8


def pack_sign_bits(signs: torch.Tensor) -> torch.Tensor:
    """(…, rot_dim) sign vectors (> 0 ⇒ bit 1) → (…, rot_dim/8) uint8 in
    the bit-plane-major layout."""
    rot_dim = signs.shape[-1]
    nb = packed_width(rot_dim)
    bits = (signs > 0).to(torch.int32)
    planes = bits.reshape(*signs.shape[:-1], 8, nb)
    weights = (1 << torch.arange(8, dtype=torch.int32,
                                 device=signs.device))[:, None]
    return (planes * weights).sum(dim=-2).to(torch.uint8)


def unpack_sign_bits(packed: torch.Tensor, rot_dim: int) -> torch.Tensor:
    """Inverse of :func:`pack_sign_bits` → (…, rot_dim) int8 in {-1, +1}."""
    nb = packed_width(rot_dim)
    if packed.shape[-1] != nb:
        raise ValueError(f"expected {nb} packed bytes, got {packed.shape[-1]}")
    return _unpack_pm1(packed)


def _unpack_pm1(packed: torch.Tensor) -> torch.Tensor:
    """(…, NB) packed bytes → (…, 8·NB) ±1 int8: column ``j·NB + r`` is
    bit j of byte r."""
    w = packed.to(torch.int32)
    bits = torch.cat([(w >> j) & 1 for j in range(8)], dim=-1)
    return (2 * bits - 1).to(torch.int8)


def multibit_width(rot_dim: int, bits: int) -> int:
    """Bytes per B-bit-encoded row: ``bits`` stacked sign planes."""
    if not 1 <= int(bits) <= 4:
        raise ValueError(f"bits must be in [1, 4], got {bits}")
    return int(bits) * packed_width(rot_dim)


def pack_code_planes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(…, rot_dim) codes in [0, 2^bits) → (…, bits·rot_dim/8) uint8:
    plane p (bit p of every code) packed by :func:`pack_sign_bits` into its
    own contiguous group. bits=1 gives exactly the 1-bit layout."""
    if not 1 <= int(bits) <= 4:
        raise ValueError(f"bits must be in [1, 4], got {bits}")
    c = codes.to(torch.int32)
    planes = [pack_sign_bits(((c >> p) & 1) * 2 - 1) for p in range(int(bits))]
    return planes[0] if bits == 1 else torch.cat(planes, dim=-1)


def unpack_code_levels(packed: torch.Tensor, rot_dim: int,
                       bits: int) -> torch.Tensor:
    """Inverse view of :func:`pack_code_planes` → (…, rot_dim) int32
    levels (odd integers in [−(2^bits−1), 2^bits−1]); bits=1 gives ±1."""
    nb = packed_width(rot_dim)
    if packed.shape[-1] != int(bits) * nb:
        raise ValueError(
            f"expected {int(bits) * nb} packed bytes, got {packed.shape[-1]}")
    lv = None
    for p in range(int(bits)):
        pm1 = _unpack_pm1(packed[..., p * nb:(p + 1) * nb]).to(torch.int32)
        lv = pm1 if lv is None else lv + (1 << p) * pm1
    return lv


def extend_query_planes(queries_rot: torch.Tensor, bits: int) -> torch.Tensor:
    """(q, rot_dim) rotated queries → (q, bits·rot_dim) plane-weighted
    query operand: position ``j·bits·nb + p·nb + r`` carries
    ``2^p · q[j·nb + r]``, matching :func:`_unpack_pm1` over a (·, bits·nb)
    packed row. bits=1 is the identity."""
    bits = int(bits)
    if bits == 1:
        return queries_rot
    q, rot_dim = queries_rot.shape
    nb = packed_width(rot_dim)
    w = (2.0 ** torch.arange(bits, device=queries_rot.device)).to(
        queries_rot.dtype)
    a = queries_rot.reshape(q, 8, 1, nb) * w[None, None, :, None]
    return a.reshape(q, 8 * bits * nb)


# ---------------------------------------------------------------------------
# The per-class call: kernel K2 on CUDA tensors, its plain twin on the CPU
# ---------------------------------------------------------------------------


def _check_bq_args(strip_list, a, list_codes, scale, bias, w_blocks, n_sub,
                   kf):
    w = ss._check_class_args(strip_list, a, list_codes, bias, w_blocks, n_sub,
                             kf, width=8 * list_codes.shape[-1])
    if tuple(scale.shape) != tuple(bias.shape):
        raise ValueError("scale must be (n_lists, m) like bias")
    return w


def _bq_class_plain(strip_list, a, list_codes, scale, bias, w_blocks: int,
                    n_sub: int, alpha: float, kf: int,
                    approx_ok: bool = False, strip_rows=None):
    """The per-class function of K2, in PyTorch ops → ((S, C, kf) fp32
    values, (S, C, kf) int32 within-list offsets).

    Scores are ``(alpha·(A·(±1)ᵀ))·scale + bias``: the codes unpacked to
    ±1 (exact in bf16), the products of the bf16 query block summed in
    fp32, then the top-kf and sub-block merge of K1's twin. Rows of
    padding strips are left at +inf / 0; rows at or past ``strip_rows``
    are unspecified (the kernel skips them) and computed here like the
    others."""
    w = _check_bq_args(strip_list, a, list_codes, scale, bias, w_blocks,
                       n_sub, kf)
    return ss._class_plain(
        strip_list, a, bias, w, n_sub, alpha, kf, approx_ok,
        lambda li, j: _unpack_pm1(list_codes[li, j * w:(j + 1) * w]).float(),
        scale=scale)


def _bq_class_cuda(strip_list, a, list_codes, scale, bias, w_blocks: int,
                   n_sub: int, alpha: float, kf: int, approx_ok: bool,
                   strip_rows=None):
    """Launch K2 (``csrc/bq_scan.cu``) on the current stream."""
    w = _check_bq_args(strip_list, a, list_codes, scale, bias, w_blocks,
                       n_sub, kf)
    ss.check_cuda_operands(a, strip_list, strip_rows, list_codes=list_codes,
                           scale=scale, bias=bias)
    if list_codes.dtype != torch.uint8:
        raise TypeError(f"list_codes must be uint8, got {list_codes.dtype}")
    dev = a.device
    s_pad, c, _ = a.shape
    sub_live = ss.sub_block_liveness(bias, w, n_sub).contiguous()
    out_v = torch.empty((s_pad, c, kf), dtype=torch.float32, device=dev)
    out_e = torch.empty((s_pad, c, kf), dtype=torch.int32, device=dev)
    if s_pad == 0:
        return out_v, out_e
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(strip_list.data_ptr(),
            None if strip_rows is None else strip_rows.data_ptr(),
            sub_live.data_ptr(), a.data_ptr(), list_codes.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), out_v.data_ptr(),
            out_e.data_ptr(), s_pad, c, list_codes.shape[2],
            list_codes.shape[1], w, n_sub, kf, float(alpha),
            int(ss.tournament_engaged(kf, w, approx_ok)), stream)
    if rc != 0:
        raise RuntimeError(_native.launch_message("bq_scan", rc))
    BQ_KERNEL.launches += 1
    BQ_KERNEL.loop = _native.last_loop("bq_scan")
    return out_v, out_e


def _kernel_fn():
    fn = _native.load("bq_scan").raft_bq_scan
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def bq_class(strip_list, a, list_codes, scale, bias, w_blocks: int,
             n_sub: int, alpha: float, kf: int, approx_ok: bool = False,
             strip_rows=None):
    """Scan one length class of packed lists: per strip ``s`` (list
    ``strip_list[s]``) and query row, the top-kf of
    ``(alpha·(A[s]·(±1)ᵀ))·scale + bias`` over the class's
    ``w = w_blocks·512`` entries per sub-block, merged over ``n_sub``
    sub-blocks → ((S, C, kf) fp32, (S, C, kf) int32 offsets in the list).
    ``a`` is (S, C, 8·nb) bf16 for ``list_codes`` (n_lists, m, nb) uint8;
    ``strip_rows`` (S,) int32, optional: strip s uses only its first
    ``strip_rows[s]`` query rows.

    CUDA tensors launch kernel K2; CPU tensors take the plain twin."""
    if a.device.type == "cuda":
        return _bq_class_cuda(strip_list, a, list_codes, scale, bias,
                              w_blocks, n_sub, alpha, kf, approx_ok,
                              strip_rows)
    return _bq_class_plain(strip_list, a, list_codes, scale, bias, w_blocks,
                           n_sub, alpha, kf, approx_ok, strip_rows)


# ---------------------------------------------------------------------------
# Tile body and entry points
# ---------------------------------------------------------------------------


def _bq_class_fn(list_codes, scale, bias, alpha: float, kf: int,
                 approx_ok: bool):
    return lambda sl, a, w_blocks, n_sub, rows: bq_class(
        sl, a, list_codes, scale, bias, w_blocks, n_sub, alpha, kf,
        approx_ok, rows)


def _bq_tile_body(queries_rot, qids, strip_list, pair_strip, pair_slot,
                  list_codes, scale, bias, list_ids, class_layout, k: int,
                  kf: int, alpha: float, pair_const=None,
                  approx_ok: bool = False):
    """One query tile of the packed scan: strip_scan's tile body with K2
    as the per-class function."""
    return ss._strip_tile_body(
        queries_rot, qids, strip_list, pair_strip, pair_slot, list_ids,
        class_layout, k, kf,
        _bq_class_fn(list_codes, scale, bias, float(alpha), kf, approx_ok),
        pair_const)


def bq_strip_search_traced(queries_rot, probes, list_codes, scale, bias,
                           list_ids, cls_ord, classes, class_counts, k: int,
                           kf: int, alpha: float, q_tile: int,
                           pair_const=None, approx_ok: bool = False):
    """Packed strip search on a static worst-case layout per query tile:
    no device→host fetch between the coarse step and the result.

    ``queries_rot`` (q, bits·rot_dim) rotated, plane-extended queries;
    ``list_codes`` (n_lists, m, bits·rot_dim/8) packed codes; ``scale`` /
    ``bias`` (n_lists, m) per-entry correction factor and additive term
    (+inf bias at padding)."""
    plan = ss.static_plan(probes, cls_ord, classes, class_counts,
                          list_codes.shape[0])
    return ss._scan_tiles(
        queries_rot, probes, list_ids, k, kf, q_tile, plan,
        _bq_class_fn(list_codes, scale, bias, float(alpha), kf, approx_ok),
        pair_const)


def bq_strip_search(queries_rot, probes, list_codes, scale, bias, list_ids,
                    lens, k: int, alpha: float = -2.0,
                    workspace_bytes: int = 1 << 30, pair_const=None,
                    approx_ok: bool = False):
    """Full packed strip scan at kernel level: probes (q, p) → per-query
    top-k over the probed lists' entries (smaller is better), planning
    each query tile from its real class counts. All tensors on one
    device; the scan runs there."""
    queries_rot = torch.as_tensor(queries_rot, device=list_codes.device)
    return ss.search_planned(
        queries_rot, probes, list_ids, lens, k, queries_rot.shape[1],
        workspace_bytes,
        lambda kf: _bq_class_fn(list_codes, scale, bias, float(alpha), kf,
                                approx_ok),
        pair_const)


# ---------------------------------------------------------------------------
# Paged packed scan (serving): kernel K4 on CUDA tensors, its twin on the CPU
# ---------------------------------------------------------------------------


def _check_paged_bq_args(strip_list, table_flat, chain_pages, sub_live, a,
                         codes, scale_pool, bias_pool, ppf, n_sub, page_rows,
                         table_width, kf):
    w = ss._check_paged_args(strip_list, table_flat, chain_pages, sub_live,
                             a, codes, bias_pool, ppf, n_sub, page_rows,
                             table_width, kf, width=8 * codes.shape[-1])
    if tuple(scale_pool.shape) != tuple(bias_pool.shape):
        raise ValueError("scale_pool must be (cap_pages, page_rows) like "
                         "bias_pool")
    return w


def _paged_bq_class_plain(strip_list, table_flat, chain_pages, sub_live, a,
                          codes, scale_pool, bias_pool, ppf: int, n_sub: int,
                          page_rows: int, table_width: int, alpha: float,
                          kf: int, strip_rows=None):
    """The per-class function of K4, in PyTorch ops: the paged twin of K3
    (:func:`strip_scan._paged_class_plain`) with the codes unpacked to ±1
    and ``(alpha·s)·scale + bias`` per live row."""
    _check_paged_bq_args(strip_list, table_flat, chain_pages, sub_live, a,
                         codes, scale_pool, bias_pool, ppf, n_sub, page_rows,
                         table_width, kf)
    return ss._paged_plain(
        strip_list, table_flat, chain_pages, sub_live, a, bias_pool, ppf,
        n_sub, page_rows, table_width, alpha, kf,
        lambda pidx: _unpack_pm1(codes[pidx]).float(), scale_pool=scale_pool)


def _paged_bq_class_cuda(strip_list, table_flat, chain_pages, sub_live, a,
                         codes, scale_pool, bias_pool, ppf: int, n_sub: int,
                         page_rows: int, table_width: int, alpha: float,
                         kf: int, strip_rows=None):
    """Launch K4 (``csrc/paged_bq_scan.cu``) on the current stream."""
    _check_paged_bq_args(strip_list, table_flat, chain_pages, sub_live, a,
                         codes, scale_pool, bias_pool, ppf, n_sub, page_rows,
                         table_width, kf)
    ss.check_cuda_operands(a, strip_list, strip_rows, codes=codes,
                           scale=scale_pool, bias=bias_pool,
                           table_flat=table_flat, chain_pages=chain_pages,
                           sub_live=sub_live)
    ss.check_paged_operands(table_flat, chain_pages, sub_live)
    if codes.dtype != torch.uint8:
        raise TypeError(f"codes must be uint8, got {codes.dtype}")
    dev = a.device
    s_pad, c, _ = a.shape
    out_v = torch.empty((s_pad, c, kf), dtype=torch.float32, device=dev)
    out_e = torch.empty((s_pad, c, kf), dtype=torch.int32, device=dev)
    if s_pad == 0:
        return out_v, out_e
    fn = _paged_kernel_fn()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(strip_list.data_ptr(),
            None if strip_rows is None else strip_rows.data_ptr(),
            table_flat.data_ptr(), chain_pages.data_ptr(),
            sub_live.data_ptr(), a.data_ptr(), codes.data_ptr(),
            scale_pool.data_ptr(), bias_pool.data_ptr(), out_v.data_ptr(),
            out_e.data_ptr(), s_pad, c, codes.shape[2], page_rows,
            table_width, ppf, n_sub, kf, float(alpha), stream)
    if rc != 0:
        raise RuntimeError(_native.launch_message("paged_bq_scan", rc))
    PAGED_BQ_KERNEL.launches += 1
    PAGED_BQ_KERNEL.loop = _native.last_loop("paged_bq_scan")
    return out_v, out_e


def _paged_kernel_fn():
    fn = _native.load("paged_bq_scan").raft_paged_bq_scan
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def paged_bq_class(strip_list, table_flat, chain_pages, sub_live, a, codes,
                   scale_pool, bias_pool, ppf: int, n_sub: int,
                   page_rows: int, table_width: int, alpha: float, kf: int,
                   strip_rows=None):
    """Scan the paged class of packed codes: per strip and query row, the
    top-kf of ``(alpha·(A[s]·(±1)ᵀ))·scale + bias`` over the live pages of
    the strip's list → ((S, C, kf) fp32, (S, C, kf) int32 offsets).
    ``codes`` (cap_pages, page_rows, nb) uint8, ``a`` (S, C, 8·nb) bf16,
    the page-walk operands as :func:`strip_scan.paged_class`'s.

    CUDA tensors launch kernel K4; CPU tensors take the plain twin."""
    if a.device.type == "cuda":
        return _paged_bq_class_cuda(strip_list, table_flat, chain_pages,
                                    sub_live, a, codes, scale_pool,
                                    bias_pool, ppf, n_sub, page_rows,
                                    table_width, alpha, kf, strip_rows)
    return _paged_bq_class_plain(strip_list, table_flat, chain_pages,
                                 sub_live, a, codes, scale_pool, bias_pool,
                                 ppf, n_sub, page_rows, table_width, alpha,
                                 kf, strip_rows)


def paged_bq_search_traced(queries_rot, probes, codes, scale_pool,
                           bias_pool, page_ids, table, chain_pages, k: int,
                           kf: int, alpha: float, q_tile: int,
                           pair_const=None, class_impl=None):
    """Paged packed strip search on the static capacity layout: strip_scan's
    paged plan and merge with K4 (``class_impl``: :func:`paged_bq_class`
    by default, or its plain twin) as the per-class function. ``queries_rot``
    (q, bits·rot_dim) rotated, plane-extended queries; ``codes``
    (cap_pages, page_rows, bits·rot_dim/8); ``scale_pool`` / ``bias_pool``
    (cap_pages, page_rows) fp32."""
    page_rows, table_width = codes.shape[1], table.shape[1]
    plan, table_flat, chain, sub_live = ss.paged_scan_setup(
        codes, bias_pool, table, chain_pages, probes, kf,
        int(codes.shape[-1]))
    class_impl = class_impl or paged_bq_class
    class_fn = lambda sl, a, ppf, n_sub, rows: class_impl(  # noqa: E731
        sl, table_flat, chain, sub_live, a, codes, scale_pool, bias_pool,
        ppf, n_sub, page_rows, table_width, float(alpha), kf, rows)
    return ss._scan_tiles(queries_rot, probes,
                          ss.PagedIds(page_ids, table, page_rows), k, kf,
                          q_tile, plan, class_fn, pair_const)


def occupancy_stats(lens, m: int, q: int, p: int, rot_dim: int,
                    workspace_bytes: int = 1 << 30, kf: int = 10,
                    bits: int = 1) -> dict:
    """Static occupancy diagnostics of one packed-scan dispatch: the strip
    planner's numbers (:func:`strip_scan.occupancy_stats`) at the scan's
    REAL planning width (the bf16 unpacked block is ``bits·rot_dim`` wide —
    the width ivf_bq's ``_ragged_plan_static`` plans with), plus the
    packed-code byte width the DMAs actually move."""
    out = ss.occupancy_stats(lens, m, q, p, dim=rot_dim * int(bits),
                             workspace_bytes=workspace_bytes, kf=kf)
    out["code_bytes_per_entry"] = multibit_width(rot_dim, bits)
    return out
