"""Strip scan — the IVF list-scan engine (counterpart of
``raft_tpu/ops/strip_scan.py``).

The unit of work is a **strip**: one probed list × up to ``C`` queries that
probe it. Per strip the engine scores ``alpha·⟨q, x⟩ + bias`` for every
entry of the list, keeps each query row's top-``kf`` inside the kernel,
and a final merge gathers each (query, probe) pair's candidates and picks
the query's top-k. Lists are length-classed (a class of ``w_blocks·512``
entries, at most ``MAX_CLASS·512`` per fetch, longer lists as ``n_sub``
sub-blocks whose running top-kf merges in the kernel).

What stays from the JAX package: the plan (``_plan_device``, the static
class layout), the merge (``merge_strip_candidates``), the per-class score
and top-kf contract. What changed: the per-class kernel is
``csrc/strip_scan.cu``, written by hand for Hopper (its note says how it
is tiled), launched by :func:`strip_class` for CUDA tensors. Its plain
twin :func:`_strip_class_plain` computes exactly the same function with
PyTorch ops; :func:`strip_class` takes it only for tensors on the CPU.
The tile body and both search drivers take the per-class function as an
argument, so the packed 1-bit scan (:mod:`raft_tpu_torch.ops.bq_scan`,
kernel K2) runs through the same plan and merge.

The paged half (serving) runs the same plan and merge over a
``PagedListStore``'s page chains: one capacity length class of ``n_sub``
sub-blocks of ``ppf`` pages (:func:`paged_plan`), scanned in place by
kernel K3 (``csrc/paged_scan.cu``) through :func:`paged_class`, whose plain
twin :func:`_paged_class_plain` is the PyTorch form of the JAX package's
``_paged_class_jnp``; :class:`PagedIds` translates (list, offset) back to
source ids through the page table.

The final merge selects with a stable sort (``lax.top_k``'s lowest-index
tie order), which is what the JAX package runs off the TPU.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.ops import _native
from raft_tpu_torch.ops.select_k import (iter_topk_min, order_key,
                                         pack_clamp_for, pack_values)

C = 192          # query rows per strip
MC = 512         # base entry block; a class-L strip reads L·MC entries
MAX_CLASS = 8    # widest single fetch (w = 4096 entries)

_PACK_BITS = 12  # low mantissa bits carrying the column (covers w ≤ 4096)
_PACK_MASK = (1 << _PACK_BITS) - 1
_NB = 128        # tournament bins (bin j = columns ≡ j mod _NB)
_KEEP = 4        # survivors per bin in the tournament pool
MAX_KF = 512     # widest per-row top-kf the kernel and its twin take
_PLAIN_CHUNK_BYTES = 256 << 20  # score block per step of the plain twin

#: launches of the hand-written K1 kernel (``csrc/strip_scan.cu``)
STRIP_KERNEL = _native.KernelCounter("strip_scan")
#: launches of the hand-written K3 kernel (``csrc/paged_scan.cu``)
PAGED_KERNEL = _native.KernelCounter("paged_scan")

# list-row types of K1 and K3 → the kernels' b_dtype codes
_B_DTYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2,
             torch.uint8: 3}


def _ceil_div(a, b):
    return -(-a // b)


def strip_eligible(m: int) -> bool:
    """True when a padded list length is a power-of-two multiple of MC."""
    return m % MC == 0 and (m // MC) & (m // MC - 1) == 0


def _bucket(n: int) -> int:
    """Two buckets per octave (pow2 and 1.5·pow2), at least 8."""
    n = max(int(n), 8)
    p = 1 << math.floor(math.log2(n))
    if n <= p:
        return p
    if n <= p + p // 2:
        return p + p // 2
    return 2 * p


def max_class_for(dim: int) -> int:
    """Largest fetch class for a row width (the JAX package's VMEM cap,
    kept so that both packages plan the same classes)."""
    if dim <= 0:
        return MAX_CLASS
    w_max = max(MC, (6 << 20) // (dim * 4 * 2))
    cls = 1
    while cls * 2 <= MAX_CLASS and cls * 2 * MC <= w_max:
        cls *= 2
    return cls


def class_info(lens_np: np.ndarray, dim: int = 0):
    """Ordered distinct (w_blocks, n_sub) classes and each list's class
    ordinal, from per-list lengths."""
    max_class = min(MAX_CLASS, max_class_for(dim)) if dim else MAX_CLASS
    n_mc = np.maximum(-(-np.maximum(lens_np, 0) // MC), 1)
    cls_full = (1 << np.ceil(np.log2(n_mc)).astype(np.int64))
    w = np.minimum(cls_full, max_class)
    sub = np.maximum(cls_full // max_class, 1)
    keys = w * (1 << 20) + sub
    uniq = np.unique(keys)
    ordinal = np.searchsorted(uniq, keys).astype(np.int32)
    classes = [(int(k_ >> 20), int(k_ & ((1 << 20) - 1))) for k_ in uniq]
    return classes, ordinal


def class_counts_of(cls_ord_np: np.ndarray, n_classes: int) -> Tuple[int, ...]:
    return tuple(int(x) for x in np.bincount(cls_ord_np, minlength=n_classes))


def static_caps(class_counts: Sequence[int], qt: int, p: int):
    """Per-class worst-case strip counts for a qt-query tile."""
    full = _ceil_div(qt * p, C)
    return tuple(_bucket(min(qt * p, full + int(nc))) for nc in class_counts)


def static_layout(classes, class_counts, qt: int, p: int):
    """Worst-case per-class layout → (region_starts, s_tot, layout) with
    layout entries (w_blocks, n_sub, start, count)."""
    caps = static_caps(class_counts, qt, p)
    starts = []
    acc = 0
    for cap in caps:
        starts.append(acc)
        acc += cap
    layout = tuple((classes[c][0], classes[c][1], starts[c], caps[c])
                   for c in range(len(classes)))
    return tuple(starts), acc, layout


def fit_q_tile(q: int, p: int, n_lists: int, n_classes: int, kf: int,
               workspace_bytes: int, dim: int = 0,
               class_counts: Optional[Sequence[int]] = None) -> int:
    """Largest query tile whose plan tables, grouped queries and kernel
    outputs stay inside the workspace budget."""
    q_tile = min(q, 16384)
    per_slot = kf * 8 + 4 + 2 * dim
    if class_counts is None:
        class_counts = tuple([n_lists] * max(n_classes, 1))

    def rows_for(qt):
        return sum(static_caps(class_counts, qt, p))

    while (rows_for(q_tile) * C * per_slot > workspace_bytes
           and q_tile > 512):
        q_tile //= 2
    return q_tile


def occupancy_stats(lens, m: int, q: int, p: int, dim: int = 0,
                    workspace_bytes: int = 1 << 30, kf: int = 10) -> dict:
    """Static occupancy diagnostics of one strip-scan dispatch (the JAX
    package's, for ``obs/roofline``), from the same planning code the
    dispatch uses (class_info / fit_q_tile / static_layout):

    * ``grid`` — per length-class ``[padded_strips, n_sub, w_blocks]``
      (the compiled kernel grids);
    * ``padded_strip_fraction`` — static-layout padding strips over the
      padded total, with the REAL strip count taken at the planner's
      best case (full ``C``-slot packing, ``ceil(q·p / C)`` — the bench
      regime; skewed probe distributions only add real strips, so this
      is the floor of the padding, not an estimate of it);
    * ``tile_fill`` — real (query, probe) pairs over the slots those
      best-case strips provide (how full the MXU M-dimension runs);
    * ``padded_row_fraction`` — scan-relative row padding: real entries
      over the pow2-block-padded widths the kernel actually fetches per
      list (every probed pair pays its list's padded width);
    * ``storage_padded_fraction`` — index-relative padding against the
      global ``m``-wide list storage (what residency pays).

    ``lens`` are per-list REAL entry counts, ``m`` the padded list width,
    ``(q, p)`` the dispatch's query/probe shape. Pure numpy."""
    lens_np = np.maximum(np.asarray(lens, np.int64), 0)
    n_lists = int(lens_np.shape[0])
    classes, cls_ord = class_info(lens_np, dim=dim)
    class_counts = class_counts_of(cls_ord, len(classes))
    q_tile = fit_q_tile(q, p, n_lists, len(classes), kf, workspace_bytes,
                        dim=dim, class_counts=class_counts)
    qt = min(q_tile, q)
    tiles = _ceil_div(q, qt) if qt else 0
    _, s_tot, layout = static_layout(classes, class_counts, qt, p)
    strips_best = _ceil_div(qt * p, C)
    n_mc = np.maximum(_ceil_div(lens_np, MC), 1)
    scanned = (1 << np.ceil(np.log2(n_mc)).astype(np.int64)) * MC
    real_rows = int(lens_np.sum())
    scanned_sum = int(scanned.sum())
    return {
        "grid": [[int(cnt), int(n_sub), int(w_blocks)]
                 for (w_blocks, n_sub, _start, cnt) in layout],
        "strips_padded": int(s_tot),
        "strips_real_bestcase": int(strips_best),
        "padded_strip_fraction": round(
            max(0.0, 1.0 - strips_best / s_tot), 4) if s_tot else 0.0,
        "tile_fill": round(min(1.0, qt * p / (strips_best * C)), 4)
        if strips_best else 0.0,
        "padded_row_fraction": round(
            max(0.0, 1.0 - real_rows / scanned_sum), 4)
        if scanned_sum else 0.0,
        "storage_padded_fraction": round(
            max(0.0, 1.0 - real_rows / (n_lists * m)), 4)
        if n_lists * m else 0.0,
        "q_tile": int(qt),
        "tiles": int(tiles),
        "c": C,
        "mc": MC,
    }


def _plan_device(probes: torch.Tensor, cls_ord: torch.Tensor, n_lists: int,
                 region_starts: Tuple[int, ...], s_tot: int):
    """Strip tables built on the probes' device: per-list pair counts by a
    left binary search over the stably sorted pair lists, class-major strip
    bases, and scatters of each pair's (strip, slot). Unused slots carry
    qids = -1 and strip_list = -1. Returns (qids (s_tot, C), strip_list
    (s_tot,), pair_strip (q, p), pair_slot (q, p), counts per class), all
    int32 except counts (int64)."""
    dev = probes.device
    q, p = probes.shape
    qp = q * p
    n_classes = len(region_starts)
    flat = probes.reshape(-1).to(torch.int64)
    order = torch.argsort(flat, stable=True)
    sorted_lists = flat[order]
    bounds = torch.searchsorted(
        sorted_lists, torch.arange(n_lists + 1, dtype=torch.int64, device=dev))
    r = bounds[1:] - bounds[:-1]
    n_qc = (r + C - 1) // C                          # strips per list

    cls64 = cls_ord.to(device=dev, dtype=torch.int64)
    list_order = torch.argsort(
        cls64 * n_lists + torch.arange(n_lists, device=dev), stable=True)
    n_qc_sorted = n_qc[list_order]
    csum = torch.cumsum(n_qc_sorted, 0) - n_qc_sorted
    cls_sorted = cls64[list_order]
    counts = torch.zeros(n_classes, dtype=torch.int64, device=dev)
    counts.index_add_(0, cls_sorted, n_qc_sorted)
    class_first = torch.cumsum(counts, 0) - counts
    starts = torch.tensor(region_starts, dtype=torch.int64, device=dev)
    base_sorted = starts[cls_sorted] + (csum - class_first[cls_sorted])
    strip_base = torch.zeros(n_lists, dtype=torch.int64, device=dev)
    strip_base[list_order] = base_sorted

    pair_off = torch.cumsum(r, 0) - r
    rank = torch.arange(qp, device=dev) - pair_off[sorted_lists]
    ps_sorted = strip_base[sorted_lists] + rank // C
    slot_sorted = rank % C
    pair_strip = torch.zeros(qp, dtype=torch.int64, device=dev)
    pair_slot = torch.zeros(qp, dtype=torch.int64, device=dev)
    pair_strip[order] = ps_sorted
    pair_slot[order] = slot_sorted

    strip_list = torch.full((s_tot,), -1, dtype=torch.int32, device=dev)
    strip_list[ps_sorted] = sorted_lists.to(torch.int32)
    qids = torch.full((s_tot, C), -1, dtype=torch.int32, device=dev)
    qids[ps_sorted, slot_sorted] = (order // p).to(torch.int32)
    return (qids, strip_list, pair_strip.to(torch.int32).reshape(q, p),
            pair_slot.to(torch.int32).reshape(q, p), counts)


def plan_tile(probes: torch.Tensor, start: int, qt: int, cls_ord, classes,
              n_lists: int):
    """Plan one query tile and fix its layout from the real per-class strip
    counts (one small device→host fetch)."""
    p = probes.shape[1]
    n_classes = len(classes)
    s_region = _bucket(min(qt * p, _ceil_div(qt * p, C) + n_lists))
    region_starts = tuple(c * s_region for c in range(n_classes))
    qids, strip_list, pair_strip, pair_slot, counts = _plan_device(
        probes[start:start + qt], cls_ord, n_lists, region_starts,
        n_classes * s_region)
    counts_np = counts.cpu().numpy()
    layout = tuple(
        (classes[c][0], classes[c][1], c * s_region,
         min(_bucket(int(counts_np[c])), s_region))
        for c in range(n_classes) if counts_np[c] > 0
    ) or ((1, 1, 0, 1),)
    return qids, strip_list, pair_strip, pair_slot, layout


def group_queries(queries_mat: torch.Tensor, qids: torch.Tensor) -> torch.Tensor:
    """The (S, C, dim) bf16 query operand: row ``qids[s, i]`` of
    ``queries_mat``, zeros where the slot is unused."""
    a = queries_mat[qids.clamp(min=0).long()]
    return torch.where((qids >= 0)[:, :, None], a,
                       torch.zeros((), dtype=a.dtype, device=a.device)
                       ).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# The per-class call: kernel K1 on CUDA tensors, its plain twin on the CPU
# ---------------------------------------------------------------------------


def tournament_engaged(kf: int, w: int, approx_ok: bool) -> bool:
    """Whether the top-kf of a (·, w) block plays the 128-bin, keep-4
    tournament (the JAX package's ``_topk_block`` rule): only when the
    caller accepts its rare bin-collision loss, 16 ≤ kf ≤ 32, the pool can
    hold kf, and it is less work than direct extraction."""
    bs = w // _NB
    wins = kf * w > _KEEP * w + kf * _KEEP * _NB
    return not (not approx_ok or kf < 16 or kf > min(bs * _KEEP, _NB // 4)
                or bs < 2 or not wins)


def _extract_topk_packed(pv: torch.Tensor, kf: int):
    """The kf smallest packed scores along the last axis, ascending →
    (values with the column bits cleared, int32 columns). Packed values of
    a row are unique, so this is a sort; values at the packing clamp come
    back as +inf."""
    _, order = torch.sort(order_key(pv), dim=-1, stable=True)
    top = torch.gather(pv, -1, order[..., :kf]).view(torch.int32)
    es = top & _PACK_MASK
    vals = (top & ~_PACK_MASK).view(torch.float32)
    vals = torch.where(vals >= pack_clamp_for(_PACK_BITS),
                       torch.full_like(vals, float("inf")), vals)
    return vals, es


def _topk_block(s: torch.Tensor, kf: int, w: int, approx_ok: bool):
    """Top-kf of (…, w) scores: packed extraction, after the tournament
    (per bin the _KEEP smallest packed values) when it is engaged."""
    pv = pack_values(s, _PACK_BITS)
    if not tournament_engaged(kf, w, approx_ok):
        return _extract_topk_packed(pv, kf)
    bs = w // _NB
    sv = pv.reshape(*pv.shape[:-1], bs, _NB)
    _, order = torch.sort(order_key(sv), dim=-2, stable=True)
    keep = torch.gather(sv, -2, order[..., :min(_KEEP, bs), :])
    if bs < _KEEP:  # an exhausted bin contributes +inf (never extracted)
        pad = torch.full((*keep.shape[:-2], _KEEP - bs, _NB), float("inf"),
                         dtype=keep.dtype, device=keep.device)
        keep = torch.cat([keep, pad], dim=-2)
    pool = keep.reshape(*pv.shape[:-1], _KEEP * _NB)   # index t·_NB + bin
    return _extract_topk_packed(pool, kf)


def _extract_topk(v: torch.Tensor, offs: torch.Tensor, kf: int):
    """kf masked-min passes over the last axis with earliest-column ties:
    the sub-block merge of the running top-kf, pass for pass as the JAX
    package runs it (an extracted slot turns +inf and may be picked again
    once only +inf is left, carrying its offset)."""
    n = v.shape[-1]
    cols = torch.arange(n, device=v.device)
    inf = torch.full((), float("inf"), dtype=v.dtype, device=v.device)
    vals, es = [], []
    for _ in range(kf):
        mn = v.min(dim=-1).values
        am = torch.where(v <= mn[..., None], cols, n).min(dim=-1).values
        hit = cols == am[..., None]
        es.append(torch.gather(offs, -1, am[..., None])[..., 0])
        vals.append(mn)
        v = torch.where(hit, inf, v)
    return torch.stack(vals, -1), torch.stack(es, -1).to(torch.int32)


def sub_block_liveness(bias: torch.Tensor, w: int, n_sub: int) -> torch.Tensor:
    """(n_lists·n_sub,) int32: 0 where every bias lane of the (list,
    sub-block) is non-finite, so the sub-block cannot rank."""
    n_lists = bias.shape[0]
    fin = torch.isfinite(bias[:, :n_sub * w]).reshape(n_lists, n_sub, w)
    return fin.any(dim=2).to(torch.int32).reshape(-1)


def _check_class_args(strip_list, a, list_data, bias, w_blocks, n_sub, kf,
                      width: Optional[int] = None):
    """Shape checks of one class call → w. ``width`` is the query operand's
    row width (default: the list rows' last dim)."""
    w = w_blocks * MC
    if a.ndim != 3 or list_data.ndim != 3 or bias.ndim != 2:
        raise ValueError("a class call wants a (S, C, dim), list rows "
                         "(n_lists, m, ·) and bias (n_lists, m)")
    width = list_data.shape[2] if width is None else width
    if a.shape[2] != width:
        raise ValueError(f"dim mismatch: {a.shape[2]} != {width}")
    if tuple(bias.shape) != tuple(list_data.shape[:2]):
        raise ValueError("bias must be (n_lists, m) like list_data")
    if strip_list.shape != (a.shape[0],):
        raise ValueError("strip_list must hold one list id per strip")
    if not 0 < kf <= min(MAX_KF, w):
        raise ValueError(f"kf must be in [1, {min(MAX_KF, w)}], got {kf}")
    if w > (1 << _PACK_BITS):
        raise ValueError(f"class width {w} exceeds the packed-column range")
    if n_sub * w > list_data.shape[1]:
        raise ValueError(f"class spans {n_sub}×{w} entries but lists hold "
                         f"{list_data.shape[1]}")
    return w


def _strip_class_plain(strip_list, a, list_data, bias, w_blocks: int,
                       n_sub: int, alpha: float, kf: int,
                       approx_ok: bool = False, strip_rows=None):
    """The per-class function of K1, in PyTorch ops → ((S, C, kf) fp32
    values, (S, C, kf) int32 within-list offsets).

    Scores are ``alpha·(A·Bᵀ) + bias`` with both operands rounded to bf16
    and the products summed in fp32 (``bf16 @ bf16`` on the CPU would
    round the result to bf16, hence the fp32 matmul of bf16-rounded
    values). Rows of padding strips (``strip_list == -1``) are left at
    +inf / 0. Rows at or past ``strip_rows`` are unspecified (the kernel
    skips them); this version computes them like the others. The merge
    reads neither."""
    w = _check_class_args(strip_list, a, list_data, bias, w_blocks, n_sub, kf)
    return _class_plain(
        strip_list, a, bias, w, n_sub, alpha, kf, approx_ok,
        lambda li, j: list_data[li, j * w:(j + 1) * w].to(torch.bfloat16).float())


def _class_plain(strip_list, a, bias, w: int, n_sub: int, alpha: float,
                 kf: int, approx_ok: bool, b_block, scale=None):
    """The per-class loop of the plain twins of K1 and K2:
    ``b_block(lists, j)`` gives the fp32 (n, w, dim) list rows of
    sub-block j (bf16-rounded values), and ``scale`` (n_lists, m), when
    given, multiplies ``alpha·s`` before the bias add."""
    s_pad, c, dim = a.shape
    dev = a.device
    out_v = torch.full((s_pad, c, kf), float("inf"), dtype=torch.float32,
                       device=dev)
    out_e = torch.zeros((s_pad, c, kf), dtype=torch.int32, device=dev)
    live_sub = sub_block_liveness(bias, w, n_sub).reshape(-1, n_sub) > 0
    lst = strip_list.to(torch.int64).clamp(min=0)
    real = strip_list >= 0
    per_strip = max(1, c * w * 4 + w * dim * 4)
    step = max(1, _PLAIN_CHUNK_BYTES // per_strip)
    iota = torch.arange(kf, dtype=torch.int32, device=dev)
    for j in range(n_sub):
        live = real & live_sub[lst, j]
        if j == 0:
            dead = (real & ~live_sub[lst, 0]).nonzero()[:, 0]
            out_v[dead] = float("inf")
            out_e[dead] = iota
        idx_all = live.nonzero()[:, 0]
        for s0 in range(0, idx_all.numel(), step):
            idx = idx_all[s0:s0 + step]
            li = lst[idx]
            s = alpha * torch.matmul(a[idx].float(),
                                     b_block(li, j).transpose(1, 2))
            if scale is not None:
                s = s * scale[li, j * w:(j + 1) * w][:, None, :]
            s = s + bias[li, j * w:(j + 1) * w][:, None, :]
            nv, ne = _topk_block(s, kf, w, approx_ok)
            ne = ne + j * w
            if j == 0:
                out_v[idx], out_e[idx] = nv, ne
            else:
                mv, me = _extract_topk(torch.cat([out_v[idx], nv], -1),
                                       torch.cat([out_e[idx], ne], -1), kf)
                out_v[idx], out_e[idx] = mv, me
    return out_v, out_e


def check_cuda_operands(a, strip_list, strip_rows, **others):
    """What a kernel wrapper checks of every class call before a launch:
    one device, a bf16 query operand, int32 strip tables, fp32 ``bias``
    (and ``scale``), contiguous operands. Raises on the first violation."""
    dev = a.device
    if strip_rows is not None and (strip_rows.shape != strip_list.shape
                                   or strip_rows.dtype != torch.int32):
        raise ValueError("strip_rows must be int32 with one count per strip")
    named = {"strip_list": strip_list, "a": a, "strip_rows": strip_rows,
             **others}
    for name, t in named.items():
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, queries on {dev}")
    if a.dtype != torch.bfloat16:
        raise TypeError(f"the query operand must be bf16, got {a.dtype}")
    if strip_list.dtype != torch.int32:
        raise TypeError("strip_list must be int32")
    for name in ("bias", "scale"):
        if name in others and others[name].dtype != torch.float32:
            raise TypeError(f"{name} must be fp32")
    for name, t in named.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _strip_class_cuda(strip_list, a, list_data, bias, w_blocks: int,
                      n_sub: int, alpha: float, kf: int, approx_ok: bool,
                      strip_rows=None):
    """Launch K1 (``csrc/strip_scan.cu``) on the current stream."""
    w = _check_class_args(strip_list, a, list_data, bias, w_blocks, n_sub, kf)
    check_cuda_operands(a, strip_list, strip_rows, list_data=list_data,
                        bias=bias)
    if list_data.dtype not in _B_DTYPES:
        raise TypeError(f"list_data must be int8, uint8, bf16 or fp32, got "
                        f"{list_data.dtype}")
    dev = a.device
    s_pad, c, dim = a.shape
    sub_live = sub_block_liveness(bias, w, n_sub).contiguous()
    out_v = torch.empty((s_pad, c, kf), dtype=torch.float32, device=dev)
    out_e = torch.empty((s_pad, c, kf), dtype=torch.int32, device=dev)
    if s_pad == 0:
        return out_v, out_e
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(strip_list.data_ptr(),
            None if strip_rows is None else strip_rows.data_ptr(),
            sub_live.data_ptr(), a.data_ptr(),
            list_data.data_ptr(), bias.data_ptr(), out_v.data_ptr(),
            out_e.data_ptr(), s_pad, c, dim, list_data.shape[1], w, n_sub,
            kf, float(alpha), int(tournament_engaged(kf, w, approx_ok)),
            _B_DTYPES[list_data.dtype], stream)
    if rc != 0:
        raise RuntimeError(_native.launch_message("strip_scan", rc))
    STRIP_KERNEL.launches += 1
    return out_v, out_e


def _kernel_fn():
    fn = _native.load("strip_scan").raft_strip_scan
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def strip_class(strip_list, a, list_data, bias, w_blocks: int, n_sub: int,
                alpha: float, kf: int, approx_ok: bool = False,
                strip_rows=None):
    """Scan one length class: per strip ``s`` (list ``strip_list[s]``) and
    query row, the top-kf of ``alpha·(A[s]·Bᵀ) + bias`` over the class's
    ``w = w_blocks·512`` entries per sub-block, merged over ``n_sub``
    sub-blocks → ((S, C, kf) fp32, (S, C, kf) int32 offsets in the list).
    ``strip_rows`` (S,) int32, optional: strip s uses only its first
    ``strip_rows[s]`` query rows; the others are left unspecified.

    CUDA tensors launch kernel K1; CPU tensors take the plain twin."""
    if a.device.type == "cuda":
        return _strip_class_cuda(strip_list, a, list_data, bias, w_blocks,
                                 n_sub, alpha, kf, approx_ok, strip_rows)
    return _strip_class_plain(strip_list, a, list_data, bias, w_blocks,
                              n_sub, alpha, kf, approx_ok, strip_rows)


# ---------------------------------------------------------------------------
# Tile body, merge, entry points
# ---------------------------------------------------------------------------


def _strip_tile_body(queries_mat, qids, strip_list, pair_strip, pair_slot,
                     list_ids, class_layout, k: int, kf: int, class_fn,
                     pair_const=None):
    """One query tile: group the queries per strip, run every length
    class through ``class_fn(strip_list, a, w_blocks, n_sub, strip_rows)``
    (K1's or K2's wrapper; for the paged scans, K3's or K4's, the layout's
    first field is the pages per fetch ``ppf``, not ``w_blocks``), then
    the candidate merge. A list's pairs fill its strips' slots in order, so
    each strip's real rows are a prefix of its C slots."""
    a_grouped = group_queries(queries_mat, qids)
    strip_rows = (qids >= 0).sum(dim=1, dtype=torch.int32)
    outs_v, outs_e = [], []
    for (w_blocks, n_sub, start, count) in class_layout:
        ov, oe = class_fn(strip_list[start:start + count],
                          a_grouped[start:start + count], w_blocks, n_sub,
                          strip_rows[start:start + count])
        outs_v.append(ov)
        outs_e.append(oe)
    out_v = torch.cat(outs_v, 0) if len(outs_v) > 1 else outs_v[0]
    out_e = torch.cat(outs_e, 0) if len(outs_e) > 1 else outs_e[0]
    return merge_strip_candidates(out_v, out_e, strip_list, pair_strip,
                                  pair_slot, list_ids, class_layout, k, kf,
                                  pair_const)


def merge_strip_candidates(out_v, out_e, strip_list, pair_strip, pair_slot,
                           list_ids, class_layout, k: int, kf: int,
                           pair_const=None):
    """Gather each (query, probe) pair's kf candidates, select the query's
    top-k and translate (list, offset) to source ids.

    ``pair_strip`` counts in the plan's numbering, where class regions may
    leave gaps; the class outputs are concatenated densely, so each pair's
    strip is remapped by its class's delta (the round-3 on-chip bug of the
    JAX package lived here: without the remap, recall fell to 0.16 once a
    class's padded count was below its region size)."""
    q, p = pair_strip.shape
    dev = out_v.device
    ps = pair_strip.to(torch.int64)
    if len(class_layout) > 1:
        concat_starts = np.cumsum([0] + [cnt for (_, _, _, cnt)
                                         in class_layout[:-1]])
        deltas = torch.tensor(
            [int(cs - start) for cs, (_, _, start, _)
             in zip(concat_starts, class_layout)], dtype=torch.int64,
            device=dev)
        cls_idx = sum((ps >= start).to(torch.int64)
                      for (_, _, start, _) in class_layout[1:])
        ps_c = ps + deltas[cls_idx]
    else:
        ps_c = ps - class_layout[0][2]
    slot = pair_slot.to(torch.int64)
    cand_v = out_v[ps_c, slot]                       # (q, p, kf)
    if pair_const is not None:
        cand_v = cand_v + pair_const[:, :, None]
    cand_v = cand_v.reshape(q, p * kf)
    cand_e = out_e[ps_c, slot].reshape(q, p * kf).to(torch.int64)
    kk = min(k, p * kf)
    vals, sel = iter_topk_min(cand_v, kk)
    sel = sel.to(torch.int64)
    win_list = torch.gather(strip_list.to(torch.int64)[ps], 1, sel // kf)
    win_off = torch.gather(cand_e, 1, sel)
    out_ids = list_ids[win_list, win_off]
    if kk < k:
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=float("inf"))
        out_ids = torch.nn.functional.pad(out_ids, (0, k - kk), value=-1)
    out_ids = torch.where(torch.isfinite(vals), out_ids,
                          torch.full_like(out_ids, -1))
    return vals, out_ids


def _scan_tiles(queries_mat, probes, list_ids, k: int, kf: int,
                q_tile: int, plan, class_fn, pair_const=None):
    """Query tiles of ``q_tile`` rows, each planned by ``plan(start, qt)``
    → (qids, strip_list, pair_strip, pair_slot, layout) and scanned by
    :func:`_strip_tile_body`."""
    q = probes.shape[0]
    out_v, out_i = [], []
    for start in range(0, q, q_tile):
        qt = min(q_tile, q - start)
        qids, strip_list, pair_strip, pair_slot, layout = plan(start, qt)
        v, i = _strip_tile_body(
            queries_mat[start:start + qt], qids, strip_list, pair_strip,
            pair_slot, list_ids, layout, int(k), kf, class_fn,
            None if pair_const is None else pair_const[start:start + qt])
        out_v.append(v)
        out_i.append(i)
    if len(out_v) == 1:
        return out_v[0], out_i[0]
    return torch.cat(out_v, 0), torch.cat(out_i, 0)


def static_plan(probes, cls_ord, classes, class_counts, n_lists: int):
    """``plan`` of :func:`_scan_tiles` on the worst-case layout per tile:
    no device→host fetch between the coarse step and the result."""
    p = probes.shape[1]

    def plan(start, qt):
        region_starts, s_tot, layout = static_layout(
            classes, class_counts, qt, p)
        qids, strip_list, pair_strip, pair_slot, _ = _plan_device(
            probes[start:start + qt], cls_ord, n_lists, region_starts, s_tot)
        return qids, strip_list, pair_strip, pair_slot, layout

    return plan


def _k1_class_fn(list_data, bias, alpha: float, kf: int, approx_ok: bool):
    return lambda sl, a, w_blocks, n_sub, rows: strip_class(
        sl, a, list_data, bias, w_blocks, n_sub, alpha, kf, approx_ok, rows)


def strip_search_traced(queries_mat, probes, list_data, bias, list_ids,
                        cls_ord, classes, class_counts, k: int, kf: int,
                        alpha: float, q_tile: int, pair_const=None,
                        approx_ok: bool = False):
    """Strip search on a static worst-case layout per query tile: no
    device→host fetch between the coarse step and the result."""
    plan = static_plan(probes, cls_ord, classes, class_counts,
                       list_data.shape[0])
    return _scan_tiles(queries_mat, probes, list_ids, k, kf, q_tile, plan,
                       _k1_class_fn(list_data, bias, float(alpha), kf,
                                    approx_ok), pair_const)


def search_planned(queries_mat, probes, list_ids, lens, k: int, dim: int,
                   workspace_bytes: int, class_fn_for, pair_const=None):
    """Plan each query tile from its real per-class strip counts and scan
    it: ``class_fn_for(kf)`` gives the per-class function. ``dim`` is the
    width the classes are planned at. Shared by :func:`strip_search` and
    the packed scan's entry point."""
    dev = list_ids.device
    probes = torch.as_tensor(probes, device=dev)
    m = list_ids.shape[1]
    if not strip_eligible(m):
        raise ValueError(
            f"list_data dim 1 must be a power-of-two multiple of {MC}, got {m}")
    if k > MC:
        raise ValueError(f"strip_search supports k <= {MC}, got {k}")
    kf = min(int(k), MC)
    n_lists = list_ids.shape[0]
    classes, cls_ord_np = class_info(np.asarray(lens), dim=dim)
    cls_ord = torch.as_tensor(cls_ord_np, device=dev)
    q_tile = fit_q_tile(probes.shape[0], probes.shape[1], n_lists,
                        len(classes), kf, workspace_bytes, dim=dim)
    return _scan_tiles(
        queries_mat, probes, list_ids, k, kf, q_tile,
        lambda start, qt: plan_tile(probes, start, qt, cls_ord, classes,
                                    n_lists),
        class_fn_for(kf), pair_const)


def strip_search(queries_mat, probes, list_data, list_bias, list_ids, lens,
                 k: int, alpha: float = -2.0,
                 workspace_bytes: int = 1 << 30, pair_const=None,
                 approx_ok: bool = False):
    """Full strip scan: probes (q, p) → per-query top-k over the probed
    lists' entries, scored ``alpha·⟨q, x⟩ + bias`` (smaller is better).

    ``list_data`` (n_lists, m, dim) fp32/bf16/int8/uint8 with m a power-of-two
    multiple of 512; ``list_bias`` (n_lists, m) fp32, +inf at padding;
    ``list_ids`` (n_lists, m), -1 at padding; ``lens`` (n_lists,) real
    entry counts. All tensors on one device; the scan runs there."""
    queries_mat = torch.as_tensor(queries_mat, device=list_data.device)
    return search_planned(
        queries_mat, probes, list_ids, lens, k, queries_mat.shape[1],
        workspace_bytes,
        lambda kf: _k1_class_fn(list_data, list_bias, float(alpha), kf,
                                approx_ok),
        pair_const)


# ---------------------------------------------------------------------------
# Paged strip scan (serving): the same engine over a PagedListStore's pools
# ---------------------------------------------------------------------------
#
# Every list is planned at its capacity (table_width × page_rows rows, one
# length class), but the kernel walks only a chain's live pages. Tombstones
# and never-filled slots self-mask through the store's bias pool (+inf);
# lanes past a sub-block's live pages are masked to +inf after the bias add,
# so stale pool rows never score.


def paged_plan(table_width: int, page_rows: int, row_bytes: int,
               kf: int) -> Tuple[int, int, int]:
    """Fetch plan of one paged scan: ``(pages_per_fetch, n_sub, w)`` with
    ``w = pages_per_fetch · page_rows`` columns per sub-block. The block
    covers ``kf`` rows, aims for the packed granule ``MC``, and stays
    inside the packing bound (w ≤ 4096) and the JAX package's 4 MB payload
    budget, so both packages plan the same blocks."""
    W, R = int(table_width), int(page_rows)

    def _ok(p_):
        w_ = p_ * R
        return w_ <= (1 << _PACK_BITS) and w_ * max(1, row_bytes) <= (4 << 20)

    ppf = 1
    while ppf < W and ppf * R < min(max(kf, MC), 1 << _PACK_BITS):
        ppf *= 2
    while ppf < W and _ok(ppf * 2):
        ppf *= 2
    while ppf > 1 and not _ok(ppf):
        ppf //= 2
    return ppf, max(1, W // ppf), ppf * R


def paged_occupancy_stats(table_width: int, page_rows: int, chain_pages,
                          live_rows: int, tombstones: int, q: int, p: int,
                          k: int, row_bytes: int,
                          workspace_bytes: int = 1 << 30,
                          dim: int = 0) -> dict:
    """Static occupancy diagnostics of one paged (K3 / K4) dispatch, from
    the same planning code the dispatch uses (:func:`paged_plan` +
    ``static_layout``). Beyond the strip numbers, the paged plane's own
    wastes:

    * ``page_fill`` — live rows over the slots of the pages actually
      chained (tail-fill waste the DMA still moves);
    * ``tombstone_fraction`` — tombstoned slots over chained-page slots
      (the waste background compaction reclaims);
    * ``chain_fill`` — chained pages over table capacity (how much of the
      capacity-planned grid the skip path prunes).

    ``chain_pages`` is the per-list live page count (numpy)."""
    chain_np = np.maximum(np.asarray(chain_pages, np.int64), 0)
    n_lists = int(chain_np.shape[0])
    kf = min(int(k), 512)
    ppf, n_sub, w = paged_plan(table_width, page_rows, row_bytes, kf)
    classes = ((ppf, n_sub),)
    class_counts = (n_lists,)
    q_tile = fit_q_tile(q, p, n_lists, 1, kf, workspace_bytes, dim=dim,
                        class_counts=class_counts)
    qt = min(q_tile, q) or 1
    _, s_tot, layout = static_layout(classes, class_counts, qt, p)
    strips_best = _ceil_div(qt * p, C)
    chained = int(chain_np.sum())
    chained_slots = chained * int(page_rows)
    cap_slots = n_lists * int(table_width) * int(page_rows)
    live = max(0, int(live_rows))
    dead = max(0, int(tombstones))
    return {
        "grid": [[int(cnt), int(ns), int(wb)]
                 for (wb, ns, _s, cnt) in layout],
        "pages_per_fetch": int(ppf),
        "n_sub": int(n_sub),
        "w": int(w),
        "strips_padded": int(s_tot),
        "strips_real_bestcase": int(strips_best),
        "padded_strip_fraction": round(
            max(0.0, 1.0 - strips_best / s_tot), 4) if s_tot else 0.0,
        "tile_fill": round(min(1.0, qt * p / (strips_best * C)), 4)
        if strips_best else 0.0,
        "page_fill": round(live / chained_slots, 4) if chained_slots
        else 0.0,
        "tombstone_fraction": round(dead / chained_slots, 4)
        if chained_slots else 0.0,
        "chain_fill": round(chained / (n_lists * table_width), 4)
        if n_lists * table_width else 0.0,
        "padded_row_fraction": round(
            max(0.0, 1.0 - live / chained_slots), 4) if chained_slots
        else 0.0,
        "capacity_slots": cap_slots,
        "q_tile": int(qt),
        "c": C,
    }


def paged_eligible(table_width: int, page_rows: int, row_bytes: int,
                   k: int) -> bool:
    """True when the paged engine can serve this store and k: the plan's
    block covers k within the packing bound and pages are at least 8 rows."""
    if page_rows < 8 or k > 512:
        return False
    _, _, w = paged_plan(table_width, page_rows, row_bytes, int(k))
    return int(k) <= min(w, table_width * page_rows, 1 << _PACK_BITS)


class PagedIds:
    """(list, in-list offset) → source id through the page table, with the
    2-D indexing :func:`merge_strip_candidates` applies to ``list_ids``:
    offset ``o`` of list ``l`` is ``page_ids[table[l, o // R], o % R]``;
    absent pages give -1."""

    __slots__ = ("page_ids", "table", "page_rows")

    def __init__(self, page_ids, table, page_rows: int):
        self.page_ids = page_ids
        self.table = table
        self.page_rows = int(page_rows)

    def __getitem__(self, idx):
        win_list, win_off = idx
        pg = self.table[win_list, win_off // self.page_rows]
        ids = self.page_ids[pg.clamp(min=0).long(), win_off % self.page_rows]
        return torch.where(pg >= 0, ids, torch.full_like(ids, -1))


def paged_sub_live(bias_pool, table, chain_pages, ppf: int,
                   n_sub: int) -> torch.Tensor:
    """(n_lists·n_sub,) int32: 1 where a (list, sub-block) holds a chained
    page with at least one finite bias row. A 0 sub-block is skipped by
    the kernel (sub-block 0 still writes its all-+inf result)."""
    n_lists, table_width = table.shape
    span = n_sub * ppf
    page_live = torch.isfinite(bias_pool).any(dim=1)            # (cap_pages,)
    slot_live = page_live[table.clamp(min=0).long()] & (table >= 0)
    if span > table_width:
        slot_live = torch.nn.functional.pad(slot_live,
                                            (0, span - table_width))
    elif span < table_width:
        slot_live = slot_live[:, :span]
    pos = torch.arange(span, device=table.device)[None, :]
    slot_live = slot_live & (pos < chain_pages.to(torch.int64)[:, None])
    return slot_live.reshape(n_lists, n_sub, ppf).any(dim=2).to(
        torch.int32).reshape(-1)


def _check_paged_args(strip_list, table_flat, chain_pages, sub_live, a,
                      pages, bias_pool, ppf: int, n_sub: int, page_rows: int,
                      table_width: int, kf: int, width: Optional[int] = None):
    """Shape checks of one paged class call → w. ``width`` is the query
    operand's row width (default: the pages' last dim)."""
    w = ppf * page_rows
    if a.ndim != 3 or pages.ndim != 3 or bias_pool.ndim != 2:
        raise ValueError("a paged class call wants a (S, C, dim), pages "
                         "(cap_pages, page_rows, ·) and bias_pool "
                         "(cap_pages, page_rows)")
    width = pages.shape[2] if width is None else width
    if a.shape[2] != width:
        raise ValueError(f"dim mismatch: {a.shape[2]} != {width}")
    if tuple(bias_pool.shape) != tuple(pages.shape[:2]):
        raise ValueError("bias_pool must be (cap_pages, page_rows) like pages")
    if pages.shape[1] != page_rows:
        raise ValueError(f"pages hold {pages.shape[1]} rows, plan says "
                         f"{page_rows}")
    if table_width < 1 or table_flat.ndim != 1 \
            or table_flat.shape[0] % table_width:
        raise ValueError("table_flat must be (n_lists·table_width,)")
    n_lists = table_flat.shape[0] // table_width
    if chain_pages.shape != (n_lists,):
        raise ValueError("chain_pages must hold one count per list")
    if sub_live.shape != (n_lists * n_sub,):
        raise ValueError("sub_live must hold one word per (list, sub-block)")
    if strip_list.shape != (a.shape[0],):
        raise ValueError("strip_list must hold one list id per strip")
    if not 0 < kf <= min(MAX_KF, w):
        raise ValueError(f"kf must be in [1, {min(MAX_KF, w)}], got {kf}")
    if w > (1 << _PACK_BITS):
        raise ValueError(f"fetch block {w} exceeds the packed-column range")
    return w


def _paged_plain(strip_list, table_flat, chain_pages, sub_live, a,
                 bias_pool, ppf: int, n_sub: int, page_rows: int,
                 table_width: int, alpha: float, kf: int, rows_of,
                 scale_pool=None):
    """The per-class loop of the paged twins (K3's and K4's), the PyTorch
    form of the JAX package's ``_paged_class_jnp``: per strip and
    sub-block j, ``nv = clamp(chain − j·ppf, 0, ppf)·sub_live`` live
    pages, scores over the block's ``w`` lanes with lanes ≥ ``nv·R``
    masked to +inf after the bias add, exact top-kf, merge into the running
    top-kf. Sub-block 0 always computes; a later one with ``nv = 0`` keeps
    the running top-kf. ``rows_of(pidx)`` gives the fp32 (…, dim) rows of
    pages ``pidx`` (bf16-rounded values); ``scale_pool``, when given,
    multiplies ``alpha·s`` before the bias add."""
    s_pad, c, dim = a.shape
    dev = a.device
    w = ppf * page_rows
    out_v = torch.full((s_pad, c, kf), float("inf"), dtype=torch.float32,
                       device=dev)
    out_e = torch.zeros((s_pad, c, kf), dtype=torch.int32, device=dev)
    table = table_flat.reshape(-1, table_width).to(torch.int64)
    live2 = sub_live.reshape(-1, n_sub).to(torch.int64)
    lst = strip_list.to(torch.int64).clamp(min=0)
    real = strip_list >= 0
    chain = torch.where(real, chain_pages.to(torch.int64)[lst], 0)
    t_idx = torch.arange(ppf, device=dev)
    lanes = torch.arange(w, device=dev)
    per_strip = max(1, c * w * 4 + w * dim * 4)
    step = max(1, _PLAIN_CHUNK_BYTES // per_strip)
    for j in range(n_sub):
        nv = (chain - j * ppf).clamp(0, ppf) * live2[lst, j]
        run = real if j == 0 else real & (nv > 0)
        idx_all = run.nonzero()[:, 0]
        for s0 in range(0, idx_all.numel(), step):
            idx = idx_all[s0:s0 + step]
            n = idx.numel()
            slot = (j * ppf + t_idx).clamp(max=table_width - 1)
            pidx = torch.where(t_idx[None, :] < nv[idx, None],
                               table[lst[idx]][:, slot], 0).clamp(min=0)
            blk = rows_of(pidx).reshape(n, w, dim)
            sc = alpha * torch.matmul(a[idx].float(), blk.transpose(1, 2))
            if scale_pool is not None:
                sc = sc * scale_pool[pidx].reshape(n, 1, w)
            sc = sc + bias_pool[pidx].reshape(n, 1, w)
            sc = torch.where(lanes[None, None, :]
                             < (nv[idx] * page_rows)[:, None, None],
                             sc, float("inf"))
            bv, be = _topk_block(sc, kf, w, False)
            be = be + j * w
            if j == 0:
                out_v[idx], out_e[idx] = bv, be
            else:
                mv, me = _extract_topk(torch.cat([out_v[idx], bv], -1),
                                       torch.cat([out_e[idx], be], -1), kf)
                out_v[idx], out_e[idx] = mv, me
    return out_v, out_e


def _paged_class_plain(strip_list, table_flat, chain_pages, sub_live, a,
                       pages, bias_pool, ppf: int, n_sub: int,
                       page_rows: int, table_width: int, alpha: float,
                       kf: int, strip_rows=None):
    """The per-class function of K3, in PyTorch ops → ((S, C, kf) fp32
    values, (S, C, kf) int32 offsets ``(j·ppf + t)·R + r`` in the list).
    Scores are ``alpha·(A·Bᵀ) + bias`` with both operands rounded to bf16
    and the products summed in fp32. Rows of padding strips are left at
    +inf / 0; rows at or past ``strip_rows`` are unspecified (the kernel
    skips them) and computed here like the others."""
    _check_paged_args(strip_list, table_flat, chain_pages, sub_live, a,
                      pages, bias_pool, ppf, n_sub, page_rows, table_width,
                      kf)
    return _paged_plain(
        strip_list, table_flat, chain_pages, sub_live, a, bias_pool, ppf,
        n_sub, page_rows, table_width, alpha, kf,
        lambda pidx: pages[pidx].to(torch.bfloat16).float())


def check_paged_operands(table_flat, chain_pages, sub_live):
    """The page-walk operands a paged kernel wrapper checks before a
    launch: int32 and contiguous."""
    for name, t in (("table_flat", table_flat), ("chain_pages", chain_pages),
                    ("sub_live", sub_live)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _paged_class_cuda(strip_list, table_flat, chain_pages, sub_live, a,
                      pages, bias_pool, ppf: int, n_sub: int,
                      page_rows: int, table_width: int, alpha: float,
                      kf: int, strip_rows=None):
    """Launch K3 (``csrc/paged_scan.cu``) on the current stream."""
    _check_paged_args(strip_list, table_flat, chain_pages, sub_live, a,
                      pages, bias_pool, ppf, n_sub, page_rows, table_width,
                      kf)
    check_cuda_operands(a, strip_list, strip_rows, pages=pages,
                        bias=bias_pool, table_flat=table_flat,
                        chain_pages=chain_pages, sub_live=sub_live)
    check_paged_operands(table_flat, chain_pages, sub_live)
    if pages.dtype not in _B_DTYPES:
        raise TypeError(f"pages must be int8, uint8, bf16 or fp32, got "
                        f"{pages.dtype}")
    dev = a.device
    s_pad, c, dim = a.shape
    out_v = torch.empty((s_pad, c, kf), dtype=torch.float32, device=dev)
    out_e = torch.empty((s_pad, c, kf), dtype=torch.int32, device=dev)
    if s_pad == 0:
        return out_v, out_e
    fn = _paged_kernel_fn()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(strip_list.data_ptr(),
            None if strip_rows is None else strip_rows.data_ptr(),
            table_flat.data_ptr(), chain_pages.data_ptr(),
            sub_live.data_ptr(), a.data_ptr(), pages.data_ptr(),
            bias_pool.data_ptr(), out_v.data_ptr(), out_e.data_ptr(),
            s_pad, c, dim, page_rows, table_width, ppf, n_sub, kf,
            float(alpha), _B_DTYPES[pages.dtype], stream)
    if rc != 0:
        raise RuntimeError(_native.launch_message("paged_scan", rc))
    PAGED_KERNEL.launches += 1
    PAGED_KERNEL.loop = _native.last_loop("paged_scan")
    return out_v, out_e


def _paged_kernel_fn():
    fn = _native.load("paged_scan").raft_paged_scan
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def paged_class(strip_list, table_flat, chain_pages, sub_live, a, pages,
                bias_pool, ppf: int, n_sub: int, page_rows: int,
                table_width: int, alpha: float, kf: int, strip_rows=None):
    """Scan the paged class: per strip ``s`` (list ``l = strip_list[s]``)
    and query row, the top-kf of ``alpha·(A[s]·Bᵀ) + bias`` over the live
    pages of ``table[l]``, ``ppf`` pages per sub-block, merged over
    ``n_sub`` sub-blocks → ((S, C, kf) fp32, (S, C, kf) int32 offsets in
    the list). ``pages`` (cap_pages, page_rows, dim) int8/uint8/bf16/fp32,
    ``bias_pool`` (cap_pages, page_rows) fp32, ``table_flat``
    (n_lists·table_width,), ``chain_pages`` (n_lists,) and ``sub_live``
    (n_lists·n_sub,) int32.

    CUDA tensors launch kernel K3; CPU tensors take the plain twin."""
    if a.device.type == "cuda":
        return _paged_class_cuda(strip_list, table_flat, chain_pages,
                                 sub_live, a, pages, bias_pool, ppf, n_sub,
                                 page_rows, table_width, alpha, kf,
                                 strip_rows)
    return _paged_class_plain(strip_list, table_flat, chain_pages, sub_live,
                              a, pages, bias_pool, ppf, n_sub, page_rows,
                              table_width, alpha, kf, strip_rows)


def paged_scan_setup(pages, bias_pool, table, chain_pages, probes, kf: int,
                     row_bytes: int):
    """What every paged search plans from the store's snapshot →
    ``(plan, table_flat, chain, sub_live)``: ``plan`` for
    :func:`_scan_tiles` on the one capacity class ``((ppf, n_sub),)``
    (:func:`paged_plan`; the layout's first field is ``ppf``, not
    ``w_blocks``), the flat table, the int32 chain lengths and the
    per-(list, sub-block) liveness. Raises when ``kf`` exceeds the fetch
    block (the running top-kf cannot recover rows a narrower block
    dropped)."""
    n_lists, table_width = table.shape
    ppf, n_sub, w = paged_plan(table_width, pages.shape[1], row_bytes, kf)
    if kf > w:
        raise ValueError(
            f"paged strip scan needs kf <= fetch block ({w} rows), got {kf}")
    sub_live = paged_sub_live(bias_pool, table, chain_pages, ppf,
                              n_sub).contiguous()
    cls_ord = torch.zeros((n_lists,), dtype=torch.int32, device=table.device)
    plan = static_plan(probes, cls_ord, ((ppf, n_sub),), (n_lists,), n_lists)
    return (plan, table.reshape(-1).contiguous(),
            chain_pages.to(torch.int32).contiguous(), sub_live)


def paged_strip_search_traced(queries_mat, probes, pages, bias_pool,
                              page_ids, table, chain_pages, k: int, kf: int,
                              alpha: float, q_tile: int, pair_const=None):
    """Paged strip search on the static capacity layout: no device→host
    fetch between the coarse step and the result.

    ``pages`` (cap_pages, page_rows, width) payload pool; ``bias_pool``
    (cap_pages, page_rows) fp32, +inf at tombstones and empty slots;
    ``page_ids`` (cap_pages, page_rows) int32; ``table`` (n_lists,
    table_width) int32, -1 at absent slots; ``chain_pages`` (n_lists,)
    int32 live pages per list."""
    page_rows, table_width = pages.shape[1], table.shape[1]
    plan, table_flat, chain, sub_live = paged_scan_setup(
        pages, bias_pool, table, chain_pages, probes, kf,
        int(pages.shape[-1]) * pages.element_size())
    class_fn = lambda sl, a, ppf, n_sub, rows: paged_class(  # noqa: E731
        sl, table_flat, chain, sub_live, a, pages, bias_pool, ppf, n_sub,
        page_rows, table_width, float(alpha), kf, rows)
    return _scan_tiles(queries_mat, probes,
                       PagedIds(page_ids, table, page_rows), k, kf, q_tile,
                       plan, class_fn, pair_const)
