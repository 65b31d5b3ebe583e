"""Roofline plane (counterpart of ``raft_tpu/obs/roofline.py``): a
per-dispatch FLOP/byte model and compute/memory utilization gauges.

Every dispatch's shapes are capacity-padded and enumerable, so FLOPs and
bytes moved are closed forms of the layout parameters:

* :func:`estimate_flops` — static FLOPs (2 per multiply-add, plus the
  per-candidate bias/scale terms) and bytes moved (operand streams and
  outputs; strip scans share one list fetch across the ``STRIP_C`` query
  slots of a strip), the JAX package's closed forms term for term.
  ``STRIP_C`` is the port's own ``ops/strip_scan.C``.
* :func:`platform_peaks` — the peak table keyed by the card's name
  (``torch.cuda.get_device_name(0)``, read only where a CUDA context
  exists): the H100 entries first (PCIe 756 TFLOP/s bf16 dense at 2.0
  TB/s, NVL 835 at 3.9, SXM 989 at 3.35), then the JAX package's TPU
  rows; the first match wins. ``RAFT_TPU_OBS_PEAK_FLOPS`` /
  ``RAFT_TPU_OBS_PEAK_BW`` override both or neither; with no match the
  source is ``"unknown"`` and no utilization is invented.
* :func:`utilization` — the fold: bound ``max(flops/peak_flops,
  bytes/peak_bw)``, its binding side, and, given a measured time,
  ``achieved_gflops``, ``mxu_utilization`` (the compute share of the
  peak; the name is the JAX package's), ``hbm_bw_utilization`` and
  ``model_to_measured``.
* The measured leg: in sync mode (``RAFT_TPU_OBS_SYNC``) the spans this
  module registers fold their committed durations into ``dispatch.<span>``
  histograms (obs/registry), and :func:`summary` pairs each noted entry
  with its histogram mean.
* :func:`xla_cost_analysis` — no XLA compiler stands behind the port: it
  returns None and records the classified
  ``roofline_xla_analysis_unavailable`` event.

Which CUDA kernel runs behind each ``*_pallas`` entry in the port:
``ivf_flat.paged_pallas`` and ``ivf_pq.paged_pallas`` are K3
(``ops/csrc/paged_scan.cu``), ``ivf_bq.paged_pallas`` is K4
(``paged_bq_scan.cu``), the ragged entries (``ivf_flat.search``,
``ivf_pq.search`` on the strip path, ``ivf_bq.search``) are K1 / K2
(``strip_scan.cu`` / ``bq_scan.cu``), and ``cagra.fused_hop`` is K6
(``cagra_hop.cu``). Entry names stay the JAX package's so both packages'
reports line up.

Dispatch sites call :func:`note_dispatch` behind their ``obs.enabled()``
gate: with telemetry off the roofline costs one branch.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Optional

from raft_tpu_torch import obs
from raft_tpu_torch.ops.strip_scan import C as STRIP_C

__all__ = [
    "BOUND_COMPUTE",
    "BOUND_MEMORY",
    "BOUND_UNKNOWN",
    "PEAK_BW_ENV",
    "PEAK_FLOPS_ENV",
    "dispatch_histogram",
    "entries",
    "estimate_flops",
    "estimate_search_flops",
    "memo_occupancy",
    "note_dispatch",
    "note_search",
    "platform_peaks",
    "reset",
    "summary",
    "utilization",
    "utilization_search",
    "xla_cost_analysis",
]

PEAK_FLOPS_ENV = "RAFT_TPU_OBS_PEAK_FLOPS"
PEAK_BW_ENV = "RAFT_TPU_OBS_PEAK_BW"

BOUND_COMPUTE, BOUND_MEMORY, BOUND_UNKNOWN = "compute", "memory", "unknown"

# ---------------------------------------------------------------------------
# per-platform peaks
# ---------------------------------------------------------------------------

#: (pattern, peak bf16 dense FLOP/s, peak memory bytes/s) per device —
#: public spec-sheet numbers, matched against a lowercased device name.
#: Ordered: the FIRST matching pattern wins, so the H100 PCIe and NVL
#: cards sit above the SXM card (``NVIDIA H100 80GB HBM3``), and the
#: lite/p TPU variants above their base generation.
_PEAK_TABLE = (
    ("h100 pcie", 756e12, 2.0e12),
    ("h100 nvl", 835e12, 3.9e12),
    ("h100", 989e12, 3.35e12),
    ("v6e", 918e12, 1640e9),
    ("v6 lite", 918e12, 1640e9),
    ("trillium", 918e12, 1640e9),
    ("v5p", 459e12, 2765e9),
    ("v5e", 197e12, 819e9),
    ("v5 lite", 197e12, 819e9),
    ("v5", 459e12, 2765e9),
    ("v4 lite", 138e12, 614e9),
    ("v4", 275e12, 1228e9),
    ("v3", 123e12, 900e9),
    ("v2", 46e12, 700e9),
)


def _env_float(env: str) -> Optional[float]:
    raw = os.environ.get(env, "").strip()
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        return None
    return v if v > 0 else None


def _device_kind() -> str:
    """``torch.cuda.get_device_name(0)`` only where a CUDA context already
    exists: a telemetry read never creates one."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return ""
    return str(torch.cuda.get_device_name(0))


def platform_peaks() -> dict:
    """``{"peak_flops", "peak_bw", "source", "device_kind"}`` — the
    roofline denominators. Resolution order: the env overrides
    (``RAFT_TPU_OBS_PEAK_FLOPS`` / ``RAFT_TPU_OBS_PEAK_BW``, both or
    neither), then the table keyed by the card's name, else zeros with
    ``source="unknown"`` — utilization against an invented peak would be
    worse than none."""
    env_f, env_b = _env_float(PEAK_FLOPS_ENV), _env_float(PEAK_BW_ENV)
    kind = _device_kind()
    if env_f and env_b:
        return {"peak_flops": env_f, "peak_bw": env_b, "source": "env",
                "device_kind": kind}
    # a PARTIAL override is ignored entirely: folding one synthetic peak
    # into the table's other would produce a half-made-up denominator
    # stamped with spec-sheet provenance — the exact failure the
    # source field exists to prevent (both knobs or neither)
    low = kind.lower()
    for pat, pf, pb in _PEAK_TABLE:
        if pat in low:
            return {"peak_flops": pf, "peak_bw": pb,
                    "source": "table", "device_kind": kind}
    return {"peak_flops": 0.0, "peak_bw": 0.0,
            "source": "unknown", "device_kind": kind}


# ---------------------------------------------------------------------------
# static FLOP / byte models (capacity-padded closed forms)
# ---------------------------------------------------------------------------


def _isize(dtype) -> int:
    from raft_tpu_torch.obs.costmodel import _isize as isize

    return isize(dtype)


def _ceil_div(a: int, b: int) -> int:
    return -(-int(a) // int(b))


def _rot_dim_pq(dim: int, pq_dim: int, rot_dim) -> int:
    return int(rot_dim) if rot_dim else pq_dim * _ceil_div(dim, pq_dim)


def _rot_dim_bq(dim: int, rot_dim, rotation_kind: str = "dense") -> int:
    if rot_dim:
        return int(rot_dim)
    if rotation_kind == "hadamard":
        # the Walsh–Hadamard width: next power of two, not byte-rounding
        return max(8, 1 << (max(int(dim), 1) - 1).bit_length())
    return _ceil_div(dim, 8) * 8


def _fb_brute_force_search(*, q, n, dim, k, dtype="float32"):
    """One tiled exact scan: the (q, n) gemm + the norm/bias add."""
    flops = 2 * q * n * dim + q * n
    br = q * dim * 4 + n * dim * _isize(dtype) + n * 4
    return flops, br, q * k * 8


def _fb_ivf_flat_search(*, q, dim, n_lists, max_list_size, n_probes, k,
                        dtype="float32"):
    """Coarse gemm + strip scan over capacity-padded lists. List traffic
    is one fetch per FULL strip (``STRIP_C`` query-pairs share it — the
    planner's best-case packing): data + per-entry bias + the merge's id
    row."""
    coarse = 2 * q * n_lists * dim
    scan = 2 * q * n_probes * max_list_size * dim \
        + q * n_probes * max_list_size
    strips = _ceil_div(q * n_probes, STRIP_C)
    br = q * dim * 4 + n_lists * dim * 4 \
        + strips * max_list_size * (dim * _isize(dtype) + 4 + 4)
    return coarse + scan, br, q * k * 8


def _fb_ivf_pq_search(*, q, dim, n_lists, max_list_size, pq_dim, n_probes,
                      k, pq_bits=8, rot_dim=None):
    """The decoded-int8 strip scan (K1 on the card): coarse gemm + query
    rotation + one rot_dim-wide contraction per probed entry (+ bias add).
    Strip traffic reads the int8 cache at 1 byte/dim."""
    rd = _rot_dim_pq(dim, pq_dim, rot_dim)
    coarse = 2 * q * n_lists * dim
    rotate = 2 * q * dim * rd
    scan = 2 * q * n_probes * max_list_size * rd \
        + q * n_probes * max_list_size
    strips = _ceil_div(q * n_probes, STRIP_C)
    br = q * dim * 4 + n_lists * dim * 4 + rd * rd * 4 \
        + strips * max_list_size * (rd + 4 + 4)
    return coarse + rotate + scan, br, q * k * 8


def _log2i(n: int) -> int:
    return max(int(n), 1).bit_length() - 1


def _rotate_cost(q: int, dim: int, rd: int, rotation_kind: str):
    """(flops, rotation-operand bytes) of rotating ``q`` rows up to width
    ``rd``: the dense gemm (2 per MAC, (rd, rd) fp32 operand) or the SRHT
    butterfly — the sign multiply, log2(rd) full-width add/sub stages and
    the 1/√d scale, with only the (rd,) sign diagonal as its operand."""
    if rotation_kind == "hadamard":
        return q * rd * (_log2i(rd) + 2), rd * 4
    return 2 * q * dim * rd, rd * rd * 4


def _fb_ivf_bq_search(*, q, dim, n_lists, max_list_size, n_probes, k,
                      rot_dim=None, bits=1, rotation_kind="dense"):
    """The packed multi-bit strip scan: coarse gemm + rotation (dense gemm
    or SRHT butterfly) + one bits·rot_dim-wide contraction per probed
    entry (every extra bit-plane widens the MXU contraction), plus the
    per-entry scale multiply AND bias add. Strip traffic reads
    bits·rot_dim/8 code bytes + two fp32 scalars per entry."""
    rd = _rot_dim_bq(dim, rot_dim, rotation_kind)
    coarse = 2 * q * n_lists * dim
    rotate, rot_bytes = _rotate_cost(q, dim, rd, rotation_kind)
    scan = 2 * q * n_probes * max_list_size * rd * bits \
        + 2 * q * n_probes * max_list_size
    strips = _ceil_div(q * n_probes, STRIP_C)
    br = q * dim * 4 + n_lists * dim * 4 + rot_bytes \
        + strips * max_list_size * (bits * rd // 8 + 4 + 4 + 4)
    return coarse + rotate + scan, br, q * k * 8


def _fb_ivf_flat_build(*, n, dim, n_lists, kmeans_iters=20, train_rows=0,
                       dtype="float32"):
    """One packed IVF-Flat build, kmeans-dominated: per CONFIGURED EM
    iteration one assign gemm + one M-step one-hot matmul over the
    trainset (4·tr·K·d — the balancing loop may extend past the
    configured budget, so this is the floor the build can't beat), the
    full-data predict, and the row-norm reduction. Bytes: the trainset
    re-streamed per iteration, the dataset twice (predict + pack read),
    the packed block written."""
    tr = train_rows or n
    flops = kmeans_iters * 4 * tr * n_lists * dim \
        + 2 * n * n_lists * dim + 2 * n * dim
    br = (kmeans_iters + 1) * tr * dim * 4 + 2 * n * dim * 4
    bw = n * (dim * _isize(dtype) + 4 + 4)
    return flops, br, bw


def _fb_ivf_pq_build(*, n, dim, n_lists, pq_dim, kmeans_iters=20,
                     codebook_iters=25, train_rows=0, cb_rows=0,
                     pq_bits=8, rot_dim=None):
    """One packed IVF-PQ build: the flat build's kmeans legs + per-subspace
    codebook Lloyd (4·cbr·n_codes·rot_dim per configured iteration) + the
    dense rotation of every row + the encode's code-scoring einsum
    (2·n·n_codes·rot_dim). Writes packed codes + ids + b_sum."""
    tr = train_rows or n
    rd = _rot_dim_pq(dim, pq_dim, rot_dim)
    n_codes = 1 << pq_bits
    cbr = cb_rows or min(tr, 65536)
    flops = kmeans_iters * 4 * tr * n_lists * dim \
        + 2 * n * n_lists * dim \
        + codebook_iters * 4 * cbr * n_codes * rd \
        + 2 * n * dim * rd + 2 * n * n_codes * rd
    br = (kmeans_iters + 1) * tr * dim * 4 + 2 * n * dim * 4 + rd * rd * 4
    bw = n * ((pq_dim * pq_bits + 7) // 8 + 4 + 4)
    return flops, br, bw


def _fb_ivf_bq_build(*, n, dim, n_lists, kmeans_iters=20, train_rows=0,
                     rot_dim=None, bits=1, rotation_kind="dense"):
    """One IVF-BQ build (packed or streamed — the op sequence is the
    same): the flat build's kmeans legs + the rotation of every row
    (dense gemm or SRHT butterfly — THE build-cost headline this round:
    O(d²) → O(d·log d) per row) + the level quantize and the
    norm/projection/bias reductions (rd·(2·bits + 4) per row, counting
    the quantize compare/scale ops per plane and the three einsum-grade
    reductions). Writes packed codes + ids + the two fp32 scalars. BQ has
    NO codebook leg — that is the IVF-RaBitQ build-time headline."""
    tr = train_rows or n
    rd = _rot_dim_bq(dim, rot_dim, rotation_kind)
    rot_f, rot_bytes = _rotate_cost(n, dim, rd, rotation_kind)
    flops = kmeans_iters * 4 * tr * n_lists * dim \
        + 2 * n * n_lists * dim + rot_f + n * rd * (2 * bits + 4)
    br = (kmeans_iters + 1) * tr * dim * 4 + 2 * n * dim * 4 + rot_bytes
    bw = n * (bits * rd // 8 + 8 + 4)
    return flops, br, bw


def _fb_srht_apply(*, n, rot_dim):
    """One SRHT rotation apply (ops/linalg.srht_rotate): the sign
    multiply, log2(rot_dim) butterfly add/sub stages and the 1/√d scale —
    n·rot_dim·(log2(rot_dim) + 2) VPU flops against n·rot_dim fp32 rows
    in/out and the (rot_dim,) sign diagonal. The O(d·log d)-vs-O(d²)
    build-cost claim as a number."""
    flops = n * rot_dim * (_log2i(rot_dim) + 2)
    br = n * rot_dim * 4 + rot_dim * 4
    return flops, br, n * rot_dim * 4


def _fb_ivf_flat_paged(*, q, dim, n_lists, page_rows, table_width,
                       n_probes, k, dtype="float32", capacity_pages=0):
    """The paged gather scan: per (query, probe) the whole capacity-padded
    chain (table_width × page_rows entries) is gathered — NO cross-query
    sharing (what the paged kernels K3 / K4 buy back, and what this model
    makes visible)."""
    ent = n_probes * table_width * page_rows
    coarse = 2 * q * n_lists * dim
    scan = 2 * q * ent * dim + q * ent
    br = q * dim * 4 + n_lists * dim * 4 \
        + q * ent * (dim * _isize(dtype) + 4 + 4)
    return coarse + scan, br, q * k * 8


def _fb_ivf_pq_paged(*, q, dim, n_lists, page_rows, table_width, pq_dim,
                     n_probes, k, pq_bits=8, rot_dim=None,
                     capacity_pages=0):
    """The paged PQ gather scan: coarse + rotation + per-query LUT build
    (pq_dim × 2^bits × dsub MACs = 2·q·2^bits·rot_dim flops) + pq_dim
    lookup-adds per gathered candidate (2 ops each: gather + add)."""
    rd = _rot_dim_pq(dim, pq_dim, rot_dim)
    n_codes = 1 << pq_bits
    code_w = (pq_dim * pq_bits + 7) // 8
    ent = n_probes * table_width * page_rows
    coarse = 2 * q * n_lists * dim
    rotate = 2 * q * dim * rd
    luts = 2 * q * n_codes * rd
    scan = 2 * q * ent * pq_dim
    br = q * dim * 4 + n_lists * dim * 4 + rd * rd * 4 \
        + pq_dim * n_codes * (rd // pq_dim) * 4 \
        + q * ent * (code_w + 4 + 4)
    return coarse + rotate + luts + scan, br, q * k * 8


def _fb_ivf_flat_paged_pallas(*, q, dim, n_lists, page_rows, table_width,
                              n_probes, k, dtype="float32"):
    """The paged strip scan (K3): coarse gemm + one
    rot-free contraction per capacity-chain row (+ bias add). Byte
    streams are PAGE-granular and strip-shared: one chain fetch (payload
    pages + the bias pool's rows) serves the ``STRIP_C`` query slots of a
    strip — the cross-query sharing the gather model cannot have. The
    model is capacity-padded by convention (the runtime skip path prunes
    dead pages; occupancy stats carry the live fractions)."""
    ent = table_width * page_rows
    coarse = 2 * q * n_lists * dim
    scan = 2 * q * n_probes * ent * dim + q * n_probes * ent
    strips = _ceil_div(q * n_probes, STRIP_C)
    br = q * dim * 4 + n_lists * dim * 4 \
        + strips * ent * (dim * _isize(dtype) + 4)
    return coarse + scan, br, q * k * 8


def _fb_ivf_pq_paged_pallas(*, q, dim, n_lists, page_rows, table_width,
                            pq_dim, n_probes, k, pq_bits=8, rot_dim=None):
    """The paged PQ scan (K3 on the int8 cache): coarse gemm + query
    rotation + one
    rot_dim-wide int8 contraction per capacity-chain row (+ bias add) —
    the decoded-cache formulation, paged. Streams the int8 cache pool at
    1 byte/dim + the 4-byte bias row, strip-shared."""
    rd = _rot_dim_pq(dim, pq_dim, rot_dim)
    ent = table_width * page_rows
    coarse = 2 * q * n_lists * dim
    rotate = 2 * q * dim * rd
    scan = 2 * q * n_probes * ent * rd + q * n_probes * ent
    strips = _ceil_div(q * n_probes, STRIP_C)
    br = q * dim * 4 + n_lists * dim * 4 + rd * rd * 4 \
        + strips * ent * (rd + 4)
    return coarse + rotate + scan, br, q * k * 8


def _fb_ivf_bq_paged_pallas(*, q, dim, n_lists, page_rows, table_width,
                            n_probes, k, rot_dim=None, bits=1,
                            rotation_kind="dense"):
    """The paged multi-bit scan (K4): coarse gemm + rotation + one
    bits·rot_dim-wide contraction per capacity-chain row, plus the per-row
    scale multiply AND bias add. Streams bits·rot_dim/8 code bytes + two
    fp32 scalars per row, strip-shared."""
    rd = _rot_dim_bq(dim, rot_dim, rotation_kind)
    ent = table_width * page_rows
    coarse = 2 * q * n_lists * dim
    rotate, rot_bytes = _rotate_cost(q, dim, rd, rotation_kind)
    scan = 2 * q * n_probes * ent * rd * bits + 2 * q * n_probes * ent
    strips = _ceil_div(q * n_probes, STRIP_C)
    br = q * dim * 4 + n_lists * dim * 4 + rot_bytes \
        + strips * ent * (bits * rd // 8 + 4 + 4)
    return coarse + rotate + scan, br, q * k * 8


def _fb_cagra_fused_hop(*, q, width, degree, proj_dim, itopk, hops=1):
    """One fused traversal hop per query block: the int8→bf16 distance
    contraction (ip + norm: 4·q·b·p), and the two exact one-hot payload
    extractions over the (itopk, itopk+b) merge (2·2·q·itopk·cat). The
    VPU dedup compare-matrix is not MXU work and is deliberately not
    counted. Traffic: parent graph rows + inlined code records (the
    in-kernel DMAs) + the three candidate buffers in and out."""
    b = width * degree
    cat = itopk + b
    flops = hops * (4 * q * b * proj_dim + 4 * q * itopk * cat)
    br = hops * (q * b * 4 + q * b * proj_dim + q * proj_dim * 4
                 + 3 * q * itopk * 4)
    bw = hops * (3 * q * itopk * 4)
    return flops, br, bw


def _fb_serving_scatter(*, n_rows, dim, payload_width,
                        payload_dtype="float32", extra_row_bytes=0):
    """One pow2-bucketed append scatter: pure data movement (flops = 0 —
    memory-bound by construction). Reads the incoming rows, writes the
    bucketed payload + id + aux + scan-bias slots, plus the kind-specific
    extra pool row (``extra_row_bytes``: PQ int8 decoded cache = rot_dim,
    BQ scale = 4, flat = 0)."""
    bucket = 1 << max(0, int(n_rows - 1).bit_length())
    br = n_rows * dim * 4
    bw = bucket * (payload_width * _isize(payload_dtype) + 4 + 4 + 4
                   + int(extra_row_bytes))
    return 0, br, bw


def _fb_maint_reencode(*, n_rows, dim, rot_dim=0, pq_dim=0, n_codes=0):
    """One maintenance re-encode pass over the cycle's affected rows
    (serving/maintenance.py): the residual rotation (2·n·rot_dim·dim
    MACs → 2 flops each; rot_dim = 0 for flat stores, which re-encode
    nothing) plus, for PQ, the per-subspace nearest-codeword search
    (n·pq_dim·n_codes·dsub MACs with dsub = rot_dim/pq_dim). Traffic:
    the float32 rows in, the rotated residual out — the code packing
    rides the same dispatch and is byte-noise next to it."""
    flops = 2 * n_rows * rot_dim * dim
    if pq_dim and n_codes:
        dsub = rot_dim // max(1, pq_dim)
        flops += 2 * n_rows * pq_dim * n_codes * dsub
    br = n_rows * dim * 4
    bw = n_rows * rot_dim * 4
    return flops, br, bw


_MODELS = {
    "brute_force.search": _fb_brute_force_search,
    "ivf_flat.search": _fb_ivf_flat_search,
    "ivf_flat.paged_scan": _fb_ivf_flat_paged,
    "ivf_flat.paged_pallas": _fb_ivf_flat_paged_pallas,
    "ivf_pq.search": _fb_ivf_pq_search,
    "ivf_pq.paged_scan": _fb_ivf_pq_paged,
    "ivf_pq.paged_pallas": _fb_ivf_pq_paged_pallas,
    "ivf_bq.search": _fb_ivf_bq_search,
    "ivf_bq.paged_pallas": _fb_ivf_bq_paged_pallas,
    "cagra.fused_hop": _fb_cagra_fused_hop,
    "serving.scatter": _fb_serving_scatter,
    "serving.maintenance.reencode": _fb_maint_reencode,
    "linalg.srht_apply": _fb_srht_apply,
    "ivf_flat.build": _fb_ivf_flat_build,
    "ivf_pq.build": _fb_ivf_pq_build,
    "ivf_bq.build": _fb_ivf_bq_build,
}

#: dispatch entry → the span whose sync-mode committed durations measure
#: it (``dispatch.<span>`` histograms, obs/registry)
_SPAN_OF = {
    "brute_force.search": "brute_force::search",
    "ivf_flat.search": "ivf_flat::scan",
    "ivf_flat.paged_scan": "ivf_flat::paged_scan",
    "ivf_flat.paged_pallas": "ivf_flat::paged_pallas",
    "ivf_pq.search": "ivf_pq::scan",
    "ivf_pq.paged_scan": "ivf_pq::paged_scan",
    "ivf_pq.paged_pallas": "ivf_pq::paged_pallas",
    "ivf_bq.search": "ivf_bq::scan",
    "ivf_bq.paged_pallas": "ivf_bq::paged_pallas",
    "cagra.fused_hop": "cagra::hop",
    "serving.scatter": "serving::upsert",
    "serving.maintenance.reencode": "serving::maintenance_recluster",
}

# opt the modeled spans into the registry's sync-mode dispatch fold —
# only these earn `dispatch.*` histograms (folding every span would
# double histogram cardinality and label host spans as device dispatches)
from raft_tpu_torch.obs.registry import register_dispatch_span as _reg_span

for _span_name in set(_SPAN_OF.values()):
    _reg_span(_span_name)
del _reg_span


def estimate_flops(entry: str, **shapes) -> dict:
    """Static FLOPs and bytes-moved of ONE dispatch of ``entry`` from its
    capacity-padded layout parameters — the roofline numerators. FLOPs
    follow the matmul convention (2 per MAC) plus the documented
    per-candidate bias/scale terms; bytes are operand streams + outputs
    (strip scans share one list fetch across ``STRIP_C`` query slots —
    the planner's best-case packing). Exact vs the hand-counted
    tiny-shape oracle (tier-1 + check.sh, zero tolerance)."""
    with obs.record_span("obs.roofline::estimate_flops",
                         attrs={"entry": entry} if obs.enabled() else None):
        fn = _MODELS.get(entry)
        if fn is None:
            raise ValueError(
                f"unknown roofline entry {entry!r} (have {sorted(_MODELS)})")
        flops, br, bw = fn(**shapes)
        total = int(br + bw)
        return {
            "entry": entry,
            "flops": int(flops),
            "bytes_read": int(br),
            "bytes_written": int(bw),
            "bytes": total,
            "arithmetic_intensity": (round(flops / total, 4) if total
                                     else None),
        }


def _search_kwargs(index, q: int, k: int, n_probes: int) -> tuple:
    """``(entry, model kwargs)`` for a live index/store — the ONE place
    the layout (``costmodel.index_layout``, shared with the HBM
    predictor) is projected onto a model's keyword surface. Everything
    index-derived (estimate_search_flops / utilization_search /
    note_search) routes through here, so layout-only keys (``norms``,
    ``plan_cache``, ``payload_width``, …) can never leak into the
    keyword-only model functions."""
    # lazy: costmodel lazily imports neighbors/serving, an edge this
    # module must not force at import time
    from raft_tpu_torch.obs import costmodel

    layout = costmodel.index_layout(index)
    kind = layout.pop("kind")
    if kind == "ivf_flat":
        return "ivf_flat.search", dict(
            q=q, k=k, n_probes=n_probes, dim=layout["dim"],
            n_lists=layout["n_lists"],
            max_list_size=layout["max_list_size"], dtype=layout["dtype"])
    if kind == "ivf_pq":
        return "ivf_pq.search", dict(
            q=q, k=k, n_probes=n_probes, dim=layout["dim"],
            n_lists=layout["n_lists"],
            max_list_size=layout["max_list_size"],
            pq_dim=layout["pq_dim"], pq_bits=layout["pq_bits"],
            rot_dim=layout["rot_dim"])
    if kind == "ivf_bq":
        return "ivf_bq.search", dict(
            q=q, k=k, n_probes=n_probes, dim=layout["dim"],
            n_lists=layout["n_lists"],
            max_list_size=layout["max_list_size"],
            rot_dim=layout["rot_dim"], bits=layout.get("bits", 1),
            rotation_kind=layout.get("rotation_kind", "dense"))
    if kind == "brute_force":
        return "brute_force.search", dict(
            q=q, k=k, n=layout["n"], dim=layout["dim"],
            dtype=layout["dtype"])
    if kind == "paged_store":
        # engine-aware: model the scan the auto backend would
        # actually dispatch — the paged Pallas strip engine where
        # eligible, the gather scan otherwise (ivf_bq has no gather path;
        # its jnp reference computes the same math as the kernel)
        from raft_tpu_torch.neighbors.ivf_flat import paged_backend_auto

        sk = layout.get("store_kind")
        engine = paged_backend_auto(index, k)
        base = dict(q=q, k=k, n_probes=n_probes, dim=layout["dim"],
                    n_lists=layout["n_lists"],
                    page_rows=layout["page_rows"],
                    table_width=layout["table_width"])
        if sk == "ivf_bq":
            return "ivf_bq.paged_pallas", dict(
                base, rot_dim=layout["rot_dim"],
                bits=layout.get("bits", 1),
                rotation_kind=layout.get("rotation_kind", "dense"))
        if sk == "ivf_pq":
            pq_kw = dict(base, pq_dim=layout["pq_dim"],
                         pq_bits=layout["pq_bits"],
                         rot_dim=layout["rot_dim"])
            return (("ivf_pq.paged_pallas", pq_kw)
                    if engine != "gather" else ("ivf_pq.paged_scan", pq_kw))
        flat_kw = dict(base, dtype=layout["payload_dtype"])
        return (("ivf_flat.paged_pallas", flat_kw)
                if engine != "gather" else ("ivf_flat.paged_scan", flat_kw))
    raise ValueError(f"no roofline model for index family {kind!r}")


def estimate_search_flops(index, q: int, k: int, n_probes: int = 0) -> dict:
    """:func:`estimate_flops` with kwargs derived from a live index/store —
    the bench-section convenience (the costmodel.estimate_search twin)."""
    entry, kwargs = _search_kwargs(index, q, k, n_probes)
    return estimate_flops(entry, **kwargs)


# ---------------------------------------------------------------------------
# roofline fold (bound + utilization)
# ---------------------------------------------------------------------------


def _fold(est: dict, peaks: dict, measured_s: Optional[float],
          occupancy: Optional[dict]) -> dict:
    """The roofline fold over ONE estimate dict (shared by
    :func:`utilization` and :func:`summary`, whose estimate is a
    per-dispatch mean): bound + measured-leg utilizations."""
    out = dict(est)
    out["peaks_source"] = peaks["source"]
    known = peaks["peak_flops"] > 0 and peaks["peak_bw"] > 0
    if known:
        ct = est["flops"] / peaks["peak_flops"]
        mt = est["bytes"] / peaks["peak_bw"]
        out["compute_bound_s"] = ct
        out["memory_bound_s"] = mt
        out["predicted_bound_s"] = max(ct, mt)
        out["bound"] = BOUND_COMPUTE if ct >= mt else BOUND_MEMORY
    else:
        out["peaks_unknown"] = True
        out["predicted_bound_s"] = None
        out["bound"] = BOUND_UNKNOWN
    if measured_s is not None and measured_s > 0:
        out["measured_s"] = float(measured_s)
        out["achieved_gflops"] = round(est["flops"] / measured_s / 1e9, 3)
        if known:
            out["mxu_utilization"] = round(
                est["flops"] / measured_s / peaks["peak_flops"], 6)
            out["hbm_bw_utilization"] = round(
                est["bytes"] / measured_s / peaks["peak_bw"], 6)
            out["model_to_measured"] = round(
                out["predicted_bound_s"] / measured_s, 6)
        else:
            out["mxu_utilization"] = None
            out["hbm_bw_utilization"] = None
    else:
        out["measured_s"] = None
    if occupancy is not None:
        out["occupancy"] = dict(occupancy)
        if "padded_row_fraction" in occupancy:
            out["padded_fraction"] = occupancy["padded_row_fraction"]
    return out


def utilization(entry: str, measured_s: Optional[float] = None,
                occupancy: Optional[dict] = None, **shapes) -> dict:
    """One entry's roofline record: the static model, the per-platform
    time bound ``max(flops/peak_flops, bytes/peak_bw)`` with its binding
    side, and — when a measured duration is supplied —
    ``achieved_gflops`` / ``mxu_utilization`` / ``hbm_bw_utilization`` /
    ``model_to_measured``. With no discoverable peaks the record is
    honest: ``bound="unknown"``, ``peaks_unknown=True``, utilizations
    None (``achieved_gflops`` still reports — it needs no denominator)."""
    with obs.record_span("obs.roofline::utilization",
                         attrs={"entry": entry} if obs.enabled() else None):
        return _fold(estimate_flops(entry, **shapes), platform_peaks(),
                     measured_s, occupancy)


def utilization_search(index, q: int, k: int, n_probes: int = 0,
                       measured_s: Optional[float] = None,
                       occupancy: Optional[dict] = None) -> dict:
    """:func:`utilization` with model kwargs derived from a live
    index/store (the bench-stamp convenience)."""
    entry, kwargs = _search_kwargs(index, q, k, n_probes)
    return utilization(entry, measured_s=measured_s, occupancy=occupancy,
                       **kwargs)


# ---------------------------------------------------------------------------
# dispatch notes (the hot-path leg) + summary (the report leg)
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_DISPATCHES: dict = {}   # entry -> {"shapes", "est", "occupancy", "count"}


def memo_occupancy(index, key: tuple, compute):
    """One-entry occupancy memo cached ON the index (the
    ``_lens_np_cache`` pattern): steady-state telemetry-on dispatches
    reuse the planner stats instead of re-running class_info/fit_q_tile/
    static_layout per call. ``key`` must capture everything the stats
    depend on (lens-cache identity, q, p, k, workspace); an index
    mutation replaces the lens cache object, which invalidates the key.
    Frozen containers that reject attribute writes just recompute."""
    cache = getattr(index, "_roofline_occ_cache", None)
    if cache is not None and cache[0] == key:
        return cache[1]
    occ = compute()
    try:
        index._roofline_occ_cache = (key, occ)
    except AttributeError:
        pass
    return occ


def note_dispatch(entry: str, shapes: dict,
                  occupancy: Optional[dict] = None) -> None:
    """Record one dispatch of ``entry`` (shape kwargs for the model, plus
    optional static occupancy stats from the kernel's planning code), so
    :func:`summary` can pair the static model with the measured
    ``dispatch.*`` histograms. FLOPs/bytes accumulate across dispatches
    (mixed shapes fold to honest per-dispatch means, not last-shape
    snapshots). NOOP when telemetry is off — callers gate, and the gate
    is re-checked here so a stray call costs one branch."""
    if not obs.enabled():
        return
    with _LOCK:
        cached = _DISPATCHES.get(entry)
        est = (cached["est"] if cached is not None
               and cached.get("shapes") == shapes else None)
    if est is None:
        # a steady-state burst of same-shape
        # dispatches (delete-heavy serving windows) reuses the last
        # estimate instead of re-running the closed form per call — the
        # model is a pure function of the shape kwargs
        est = estimate_flops(entry, **shapes)
    with _LOCK:
        rec = _DISPATCHES.get(entry)
        if rec is None:
            rec = _DISPATCHES[entry] = {"count": 0, "total_flops": 0,
                                        "total_bytes_read": 0,
                                        "total_bytes_written": 0}
        rec["count"] += 1
        rec["total_flops"] += est["flops"]
        rec["total_bytes_read"] += est["bytes_read"]
        rec["total_bytes_written"] += est["bytes_written"]
        rec["shapes"] = dict(shapes)
        rec["est"] = est
        if occupancy is not None:
            rec["occupancy"] = dict(occupancy)
    obs.set_gauge(f"roofline.{entry}.flops", est["flops"])
    obs.set_gauge(f"roofline.{entry}.bytes", est["bytes"])


def note_search(index, q: int, k: int, n_probes: int = 0,
                occupancy: Optional[dict] = None) -> None:
    """:func:`note_dispatch` from a live index/store (search-site sugar;
    the shared ``_search_kwargs`` projection, so layout-only keys can
    never poison the note registry)."""
    if not obs.enabled():
        return
    entry, kwargs = _search_kwargs(index, q, k, n_probes)
    note_dispatch(entry, kwargs, occupancy=occupancy)


def entries() -> dict:
    """{entry: dispatch-note record} for every entry noted so far."""
    with _LOCK:
        return {k: dict(v) for k, v in _DISPATCHES.items()}


def reset() -> None:
    """Clear the dispatch-note registry (tests)."""
    with _LOCK:
        _DISPATCHES.clear()


def dispatch_histogram(entry: str,
                       snapshot: Optional[dict] = None) -> Optional[dict]:
    """The ``dispatch.<span>`` histogram measuring ``entry`` (committed
    sync-mode durations; obs/registry), or None when sync attribution
    never ran for it."""
    from raft_tpu_torch.obs.registry import DISPATCH_HIST_PREFIX

    span = _SPAN_OF.get(entry)
    if span is None:
        return None
    snap = snapshot if snapshot is not None else obs.snapshot()
    return (snap.get("histograms") or {}).get(
        f"{DISPATCH_HIST_PREFIX}{span}")


def summary(snapshot: Optional[dict] = None) -> dict:
    """One report-ready roofline section: the platform peaks and, per
    noted entry, the static model + measured fold + occupancy. Both legs
    are PER-DISPATCH MEANS over the window — mean FLOPs/bytes over every
    noted dispatch against the histogram-mean committed duration (the
    sync-mode ``dispatch.*`` fold; ``measured_s=None`` honestly when
    ``RAFT_TPU_OBS_SYNC`` never ran) — so mixed-shape windows (a serving
    bucket ramp) report window-average utilization, never one shape's
    model against another shape's time. Numeric utilizations also land
    as ``roofline.<entry>.*`` gauges so the fleet merge carries them."""
    with obs.record_span("obs.roofline::summary"):
        peaks = platform_peaks()
        snap = snapshot if snapshot is not None else obs.snapshot()
        out_entries = {}
        for entry, rec in entries().items():
            n = rec.get("count", 0)
            if not n:
                continue
            h = dispatch_histogram(entry, snap)
            measured = None
            if h and h.get("count"):
                measured = h["sum"] / h["count"]
            br = rec["total_bytes_read"] / n
            bw = rec["total_bytes_written"] / n
            est = {
                "entry": entry,
                "flops": rec["total_flops"] / n,
                "bytes_read": br,
                "bytes_written": bw,
                "bytes": br + bw,
                "arithmetic_intensity": (
                    round(rec["total_flops"] / n / (br + bw), 4)
                    if br + bw else None),
            }
            row = _fold(est, peaks, measured, rec.get("occupancy"))
            row["dispatches"] = n
            row["last_shapes"] = dict(rec.get("shapes") or {})
            out_entries[entry] = row
            if obs.enabled():
                for key in ("mxu_utilization", "hbm_bw_utilization",
                            "achieved_gflops"):
                    v = row.get(key)
                    if isinstance(v, (int, float)):
                        obs.set_gauge(f"roofline.{entry}.{key}", v)
        return {"peaks": peaks, "entries": out_entries}


# ---------------------------------------------------------------------------
# compiler cross-check
# ---------------------------------------------------------------------------


def xla_cost_analysis(jitted, *args, **kwargs) -> Optional[dict]:
    """The compiler's own FLOP accounting of one lowering, where a
    compiler offers it. No XLA stands behind the port, so this returns
    None and records the classified ``roofline_xla_analysis_unavailable``
    event — the JAX package's answer on a backend without
    ``cost_analysis``. The static model stands alone."""
    from raft_tpu_torch import resilience

    with obs.record_span("obs.roofline::xla_cost_analysis"):
        err = NotImplementedError(
            "no XLA compiler behind the port: eager PyTorch and CUDA "
            "kernels have no cost_analysis")
        resilience.record_event(
            "roofline_xla_analysis_unavailable",
            kind=resilience.classify(err), error=repr(err)[:200])
        return None
