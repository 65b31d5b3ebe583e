"""Static memory footprint prediction and pre-dispatch admission
(counterpart of ``raft_tpu/obs/costmodel.py``, same formulas, thresholds
and verdicts).

Every scan operand's shape derives from layout parameters known on the
host (n_lists, max_list_size, page capacity, table width), never from
data, so a dispatch's footprint is a sum of closed-form terms computed
before anything touches the card:

* :func:`predict_index_bytes` — resident bytes of an index from its layout
  alone, for brute_force / ivf_flat / ivf_pq / ivf_bq / cagra and the
  serving ``PagedListStore``. Exact against ``obs.memory.index_bytes`` of
  the port's built object: the formula is the JAX package's, and the
  port's fields are laid out to match it.
* :func:`estimate` — one dispatch's operand, output and workspace bytes per
  entry, with the dispatch sites' own ``per_query`` / ``q_tile`` workspace
  arithmetic; :func:`estimate_search` builds the arguments from a live
  index or store.
* :func:`xla_memory_analysis` — there is no XLA compiler behind the port,
  so it returns None and records the classified
  ``costmodel_xla_analysis_unavailable`` event, as the JAX package does
  where a backend lacks the analysis.
* :func:`check_admission` — projects a predicted footprint against the
  live watermark (``obs/memory``) and a memory budget (the card's total
  from ``torch.cuda.mem_get_info``, or ``RAFT_TPU_OBS_HBM_BYTES``),
  returning a classified ``ADMIT`` / ``QUEUE`` / ``REJECT`` record. It
  never raises.

Thresholds: a projection under ``RAFT_TPU_OBS_ADMIT_SOFT`` (default 0.85)
of the budget ADMITs, under ``RAFT_TPU_OBS_ADMIT_HARD`` (default 0.97)
QUEUEs, above it REJECTs; with no budget the verdict is ADMIT with
``budget_source="unknown"``.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from raft_tpu_torch import obs
from raft_tpu_torch.obs import compile as obs_compile
from raft_tpu_torch.obs import memory as obs_memory

__all__ = [
    "ADMIT",
    "HARD_ENV",
    "HBM_ENV",
    "QUEUE",
    "REJECT",
    "SOFT_ENV",
    "admission_counts",
    "check_admission",
    "dtype_name",
    "estimate",
    "estimate_search",
    "hbm_budget",
    "index_layout",
    "paged_scan_estimator",
    "predict_index_bytes",
    "xla_memory_analysis",
]

ADMIT, QUEUE, REJECT = "admit", "queue", "reject"

#: counter namespace every verdict lands under (obs registry); consumers
#: fold it back out with :func:`admission_counts`
ADMISSION_COUNTER_PREFIX = "costmodel.admission."

HBM_ENV = "RAFT_TPU_OBS_HBM_BYTES"
SOFT_ENV = "RAFT_TPU_OBS_ADMIT_SOFT"
HARD_ENV = "RAFT_TPU_OBS_ADMIT_HARD"


def _frac(env: str, default: float) -> float:
    raw = os.environ.get(env, "").strip()
    try:
        v = float(raw) if raw else default
    except ValueError:
        v = default
    return min(max(v, 0.0), 1.0)


#: element sizes numpy cannot name
_ISIZE_EXTRA = {"bfloat16": 2}


def dtype_name(dtype) -> str:
    """The numpy-style name of a torch or numpy dtype (``"uint8"``), as the
    JAX package's layouts and models name it."""
    return str(dtype).replace("torch.", "")


def _isize(dtype) -> int:
    name = dtype_name(dtype)
    if name in _ISIZE_EXTRA:
        return _ISIZE_EXTRA[name]
    return int(np.dtype(name).itemsize)


# ---------------------------------------------------------------------------
# resident-index prediction (the five families + the paged store)
# ---------------------------------------------------------------------------


def _predict_brute_force(*, n: int, dim: int, dtype="float32",
                         norms: bool = True) -> int:
    total = n * dim * _isize(dtype)
    if norms:
        total += n * 4
    return total


def _predict_ivf_flat(*, n_lists: int, dim: int, max_list_size: int,
                      dtype="float32", norms: bool = True,
                      plan_cache: bool = False) -> int:
    total = n_lists * dim * 4                                # centers
    total += n_lists * max_list_size * dim * _isize(dtype)   # list_data
    total += n_lists * max_list_size * 4                     # list_ids
    if norms:
        total += n_lists * max_list_size * 4                 # list_norms
    if plan_cache:
        total += n_lists * 4     # _lens_np_cache (first ragged-plan search)
    return total


def _predict_ivf_pq(*, n_lists: int, dim: int, max_list_size: int,
                    pq_dim: int, pq_bits: int = 8,
                    rot_dim: Optional[int] = None,
                    codebook_kind: str = "subspace",
                    decoded: bool = False,
                    plan_cache: bool = False) -> int:
    if rot_dim is None:
        rot_dim = pq_dim * (-(-dim // pq_dim))
    dsub = rot_dim // pq_dim
    n_codes = 1 << pq_bits
    code_width = (pq_dim * pq_bits + 7) // 8
    total = n_lists * dim * 4                                # centers
    total += rot_dim * rot_dim * 4                           # rotation
    cb_rows = n_lists if codebook_kind == "cluster" else pq_dim
    total += cb_rows * n_codes * dsub * 4                    # codebooks
    total += n_lists * max_list_size * code_width            # list_codes
    total += n_lists * max_list_size * 4                     # list_ids
    total += n_lists * max_list_size * 4                     # b_sum
    if decoded:
        total += n_lists * max_list_size * rot_dim + 4       # int8 + scale
    if plan_cache:
        total += n_lists * 4     # _lens_np_cache (first ragged-plan search)
    return total


def _rotation_bytes(rot_dim: int, rotation_kind: str) -> int:
    """Resident bytes of the rotation operand: the dense (rot_dim, rot_dim)
    fp32 matrix, or the SRHT (rot_dim,) fp32 sign diagonal — the 1/d
    storage side of the Hadamard rotation's O(d·log d) apply."""
    if rotation_kind == "hadamard":
        return rot_dim * 4
    return rot_dim * rot_dim * 4


def _auto_rot_dim_bq(dim: int, rotation_kind: str) -> int:
    """ivf_bq.auto_rot_dim mirrored (kind-aware): whole code bytes for
    dense, the next power of two for the Walsh–Hadamard butterfly — the
    kinds disagree (dim=100 → 104 vs 128), so a kind-blind default would
    under-predict every hadamard byte count."""
    if rotation_kind == "hadamard":
        d = max(int(dim), 1)
        return max(8, 1 << (d - 1).bit_length())
    return -(-int(dim) // 8) * 8


def _predict_ivf_bq(*, n_lists: int, dim: int, max_list_size: int,
                    rot_dim: Optional[int] = None, bits: int = 1,
                    rotation_kind: str = "dense",
                    plan_cache: bool = False) -> int:
    if rot_dim is None:
        rot_dim = _auto_rot_dim_bq(dim, rotation_kind)
    total = n_lists * dim * 4                                # centers
    total += _rotation_bytes(rot_dim, rotation_kind)         # rotation
    total += n_lists * max_list_size * (bits * rot_dim // 8)  # list_codes
    total += n_lists * max_list_size * 4                     # list_ids
    total += n_lists * max_list_size * 4                     # list_scale
    total += n_lists * max_list_size * 4                     # list_bias
    if plan_cache:
        total += n_lists * 4     # _lens_np_cache (first ragged-plan search)
    return total


def _predict_cagra(*, n: int, dim: int, graph_degree: int, dtype="float32",
                   proj_dim: int = 0, n_centroids: int = 0) -> int:
    total = n * dim * _isize(dtype)                          # dataset
    total += n * graph_degree * 4                            # graph
    total += n * 4                                           # norms
    if proj_dim:
        total += dim * proj_dim * 4 + 4 + 4                  # proj+scale+energy
        total += n * graph_degree * proj_dim                 # nbr_codes int8
    if n_centroids:
        total += n_centroids * dim * 4 + n_centroids * 4
    return total


def _predict_paged_store(*, n_lists: int, dim: int, capacity_pages: int,
                         page_rows: int, table_width: int, payload_width: int,
                         payload_dtype="float32", store_kind: str = "ivf_flat",
                         pq_dim: int = 0, pq_bits: int = 8,
                         rot_dim: Optional[int] = None,
                         rotation_kind: str = "dense", bits: int = 1,
                         paged_plan_cache: bool = False) -> int:
    # ``bits`` (BQ multi-bit stores) rides in the payload_width the caller
    # measured off the pool — accepted here so index_layout() round-trips
    del bits
    total = n_lists * dim * 4                                         # centers
    total += capacity_pages * page_rows * payload_width * _isize(payload_dtype)
    total += capacity_pages * page_rows * 4                           # page_ids
    total += capacity_pages * page_rows * 4                           # page_aux
    total += capacity_pages * page_rows * 4           # page_bias
    total += n_lists * table_width * 4                        # device table
    # host bookkeeping (counted by index_bytes too — numpy arrays carry
    # nbytes): page table + per-list chain lengths + per-page fill counts
    # + page→list ownership + per-list live-row counters (drift
    # detection)
    total += n_lists * table_width * 4                          # host _table
    total += n_lists * 4                                        # _list_pages
    total += capacity_pages * 4                                 # _fill
    total += capacity_pages * 4                                 # _page_list
    total += n_lists * 8                                        # _list_live
    if paged_plan_cache:
        # the paged Pallas path's device chain-length mirror (_dev_lens),
        # materialized on its first search
        total += n_lists * 4
    if store_kind == "ivf_pq":
        if rot_dim is None:
            rot_dim = pq_dim * (-(-dim // pq_dim))
        total += rot_dim * rot_dim * 4                                # rotation
        total += pq_dim * (1 << pq_bits) * (rot_dim // pq_dim) * 4    # codebooks
        total += capacity_pages * page_rows * rot_dim       # page_cache int8
        total += 4                                  # decoded_scale (0-d fp32)
    elif store_kind == "ivf_bq":
        if rot_dim is None:
            rot_dim = _auto_rot_dim_bq(dim, rotation_kind)
        total += _rotation_bytes(rot_dim, rotation_kind)              # rotation
        total += capacity_pages * page_rows * 4             # page_scale
    return total


_FAMILIES = {
    "brute_force": _predict_brute_force,
    "ivf_flat": _predict_ivf_flat,
    "ivf_pq": _predict_ivf_pq,
    "ivf_bq": _predict_ivf_bq,
    "cagra": _predict_cagra,
    "paged_store": _predict_paged_store,
}


def predict_index_bytes(kind: str, **layout) -> int:
    """Resident bytes of a ``kind`` index from its capacity-padded layout
    parameters — computable BEFORE the index exists (the admission
    controller's build-side input), and EXACT against
    ``obs.memory.index_bytes`` of the built artifact (the formula is the
    field layout; tier-1 property-tests pin the equality for
    flat/pq/bq)."""
    with obs.record_span("obs.costmodel::predict_index_bytes",
                         attrs={"kind": kind} if obs.enabled() else None):
        fn = _FAMILIES.get(kind)
        if fn is None:
            raise ValueError(
                f"unknown index family {kind!r} (have {sorted(_FAMILIES)})")
        return int(fn(**layout))


def predict_build_streaming_bytes(*, n: int, dim: int, n_lists: int,
                                  max_list_size: int, chunk_rows: int,
                                  train_rows: int = 0,
                                  rot_dim: Optional[int] = None,
                                  bits: int = 1,
                                  rotation_kind: str = "dense") -> dict:
    """Predicted PEAK resident bytes of one ``ivf_bq.build_streaming`` run
    — the bound the streamed build exists to enforce: the donated index
    blocks plus ONE chunk's encode transient (never the raw (n, dim)
    matrix). Closed-form, computable before the build runs (the
    billion-scale admission input: at the SIFT-1B 15.6M-row per-chip
    share this is the number that must fit next to the serving residents).

    Returns ``{"index_bytes", "chunk_transient_bytes", "labels_bytes",
    "train_bytes", "peak_bytes"}`` where ``peak_bytes = index + pass-1
    labels + max(chunk transient, training residents)`` — the two phases'
    peaks never coexist (the trainset is freed before pass 2).
    ``train_rows=0`` resolves to the build's own default sample
    (min(2M, max(n_lists·32, n·0.5)) — the default trainset fraction;
    pass ``train_rows`` explicitly for other configurations. Modeling
    the sentinel as zero residency would under-predict by the whole
    trainset), and ``train_bytes`` counts 2× the sample: the per-chunk
    parts and their concatenation coexist transiently
    (the concatenation in build_streaming's training phase)."""
    if rot_dim is None:
        rot_dim = _auto_rot_dim_bq(dim, rotation_kind)
    idx = _predict_ivf_bq(n_lists=n_lists, dim=dim,
                          max_list_size=max_list_size, rot_dim=rot_dim,
                          bits=bits, rotation_kind=rotation_kind)
    # one chunk in flight: the fp32 rows, the rotated residual u and its
    # fp32 level view (the g/proj einsum operand), the packed codes, and
    # the per-row labels/scale/bias scalars
    chunk_t = int(chunk_rows) * (dim * 4 + 2 * rot_dim * 4
                                 + (bits * rot_dim) // 8 + 16)
    labels = int(n) * 4                   # pass-1 labels, kept whole-run
    t_rows = int(train_rows) or int(min(2_000_000,
                                        max(n_lists * 32, n * 0.5)))
    t_rows = min(t_rows, int(n))
    train = 2 * t_rows * dim * 4          # parts + concat coexist
    return {"index_bytes": int(idx), "chunk_transient_bytes": int(chunk_t),
            "labels_bytes": int(labels), "train_bytes": int(train),
            "peak_bytes": int(idx + labels + max(chunk_t, train))}


def index_layout(index) -> dict:
    """``{"kind": ..., **layout}`` of a built index/store, suitable for
    ``predict_index_bytes(**index_layout(idx))`` — how the bench stamps
    verify the predictor against the ``index_bytes`` gauge of the real
    artifact."""
    # lazy imports: neighbors/serving import obs, so the reverse edge must
    # not run at module import time
    from raft_tpu_torch.neighbors import brute_force as bf_mod
    from raft_tpu_torch.neighbors import cagra as cagra_mod
    from raft_tpu_torch.neighbors import ivf_bq as bq_mod
    from raft_tpu_torch.neighbors import ivf_flat as flat_mod
    from raft_tpu_torch.neighbors import ivf_pq as pq_mod
    from raft_tpu_torch.serving.store import PagedListStore

    # the ragged-plan search path memoizes a (n_lists,) host array on the
    # index after its first search — part of the artifact's real footprint
    plan = getattr(index, "_lens_np_cache", None) is not None
    if isinstance(index, flat_mod.IvfFlatIndex):
        return {"kind": "ivf_flat", "n_lists": index.n_lists,
                "dim": index.dim, "max_list_size": index.max_list_size,
                "dtype": dtype_name(index.list_data.dtype),
                "norms": index.list_norms is not None, "plan_cache": plan}
    if isinstance(index, pq_mod.IvfPqIndex):
        return {"kind": "ivf_pq", "n_lists": index.n_lists,
                "dim": index.dim, "max_list_size": index.max_list_size,
                "pq_dim": index.pq_dim, "pq_bits": index.pq_bits,
                "rot_dim": int(index.rotation.shape[0]),
                "codebook_kind": index.codebook_kind,
                "decoded": index.decoded is not None, "plan_cache": plan}
    if isinstance(index, bq_mod.IvfBqIndex):
        return {"kind": "ivf_bq", "n_lists": index.n_lists,
                "dim": index.dim, "max_list_size": index.max_list_size,
                "rot_dim": index.rot_dim, "bits": index.bits,
                "rotation_kind": index.rotation_kind, "plan_cache": plan}
    if isinstance(index, cagra_mod.CagraIndex):
        return {"kind": "cagra", "n": index.size, "dim": index.dim,
                "graph_degree": index.graph_degree,
                "dtype": dtype_name(index.dataset.dtype),
                "proj_dim": (0 if index.proj is None
                             else int(index.proj.shape[1])),
                "n_centroids": (0 if index.centroids is None
                                else int(index.centroids.shape[0]))}
    if isinstance(index, bf_mod.BruteForceIndex):
        return {"kind": "brute_force", "n": index.size, "dim": index.dim,
                "dtype": dtype_name(index.dataset.dtype),
                "norms": index.norms is not None}
    if isinstance(index, PagedListStore):
        return {"kind": "paged_store", "store_kind": index.kind,
                "n_lists": index.n_lists, "dim": index.dim,
                "capacity_pages": index.capacity_pages,
                "page_rows": index.page_rows,
                "table_width": index.table_width,
                "payload_width": int(index.pages.shape[2]),
                "payload_dtype": dtype_name(index.pages.dtype),
                "pq_dim": index.pq_dim, "pq_bits": index.pq_bits,
                "rot_dim": (None if index.rotation is None
                            else int(index.rotation.shape[0])),
                "rotation_kind": getattr(index, "rotation_kind", "dense"),
                "bits": int(getattr(index, "bq_bits", 1)),
                # the paged Pallas path's lazily-built device mirror
                "paged_plan_cache": getattr(index, "_dev_lens", None)
                is not None}
    raise TypeError(f"unsupported index type {type(index).__name__}")


# ---------------------------------------------------------------------------
# per-dispatch estimators (operand + output + workspace)
# ---------------------------------------------------------------------------


def _ws_tile(q: int, per_query: int, workspace_bytes: int) -> int:
    """The dispatch sites' own tile arithmetic (ivf_flat.search et al.):
    q_tile = clamp(workspace // per_query, 1..q)."""
    return int(max(1, min(q, workspace_bytes // max(1, per_query))))


def _workspace_bytes() -> int:
    from raft_tpu_torch.core.resources import current_resources

    return int(current_resources().workspace_bytes)


def _est_ivf_flat_search(*, q, dim, n_lists, max_list_size, n_probes, k,
                         dtype="float32", norms=True, workspace_bytes=None):
    ws = workspace_bytes if workspace_bytes is not None else _workspace_bytes()
    operands = q * dim * 4 + _predict_ivf_flat(
        n_lists=n_lists, dim=dim, max_list_size=max_list_size, dtype=dtype,
        norms=norms)
    per_query = max(1, n_probes * max_list_size * (dim + 2) * 4)
    qt = _ws_tile(q, per_query, ws)
    workspace = qt * per_query + q * n_lists * 8       # gather tile + coarse
    outputs = q * k * 8
    return operands, outputs, workspace


def _est_ivf_flat_paged(*, q, dim, n_lists, capacity_pages, page_rows,
                        table_width, n_probes, k, dtype="float32",
                        workspace_bytes=None):
    ws = workspace_bytes if workspace_bytes is not None else _workspace_bytes()
    operands = q * dim * 4 + _predict_paged_store(
        n_lists=n_lists, dim=dim, capacity_pages=capacity_pages,
        page_rows=page_rows, table_width=table_width, payload_width=dim,
        payload_dtype=dtype)
    per_query = max(1, n_probes * table_width * page_rows * (dim + 2) * 4)
    qt = _ws_tile(q, per_query, ws)
    workspace = qt * per_query + q * n_lists * 8
    outputs = q * k * 8
    return operands, outputs, workspace


def _est_ivf_pq_search(*, q, dim, n_lists, max_list_size, pq_dim, n_probes,
                       k, pq_bits=8, rot_dim=None, workspace_bytes=None):
    ws = workspace_bytes if workspace_bytes is not None else _workspace_bytes()
    if rot_dim is None:
        rot_dim = pq_dim * (-(-dim // pq_dim))
    operands = q * dim * 4 + _predict_ivf_pq(
        n_lists=n_lists, dim=dim, max_list_size=max_list_size, pq_dim=pq_dim,
        pq_bits=pq_bits, rot_dim=rot_dim)
    per_query = max(1, n_probes * max_list_size * (pq_dim * 5 + 8))
    qt = _ws_tile(q, per_query, ws)
    luts = q * pq_dim * (1 << pq_bits) * 4
    workspace = qt * per_query + luts + q * n_lists * 8
    outputs = q * k * 8
    return operands, outputs, workspace


def _est_ivf_pq_paged(*, q, dim, n_lists, capacity_pages, page_rows,
                      table_width, pq_dim, n_probes, k, pq_bits=8,
                      rot_dim=None, workspace_bytes=None):
    ws = workspace_bytes if workspace_bytes is not None else _workspace_bytes()
    code_width = (pq_dim * pq_bits + 7) // 8
    operands = q * dim * 4 + _predict_paged_store(
        n_lists=n_lists, dim=dim, capacity_pages=capacity_pages,
        page_rows=page_rows, table_width=table_width,
        payload_width=code_width, payload_dtype="uint8", store_kind="ivf_pq",
        pq_dim=pq_dim, pq_bits=pq_bits, rot_dim=rot_dim)
    per_query = max(1, n_probes * table_width * page_rows * (pq_dim * 5 + 8))
    qt = _ws_tile(q, per_query, ws)
    luts = q * pq_dim * (1 << pq_bits) * 4
    workspace = qt * per_query + luts + q * n_lists * 8
    outputs = q * k * 8
    return operands, outputs, workspace


def _est_ivf_bq_search(*, q, dim, n_lists, max_list_size, n_probes, k,
                       rot_dim=None, bits=1, rotation_kind="dense",
                       workspace_bytes=None):
    ws = workspace_bytes if workspace_bytes is not None else _workspace_bytes()
    if rot_dim is None:
        rot_dim = _auto_rot_dim_bq(dim, rotation_kind)
    operands = q * dim * 4 + _predict_ivf_bq(
        n_lists=n_lists, dim=dim, max_list_size=max_list_size,
        rot_dim=rot_dim, bits=bits, rotation_kind=rotation_kind)
    # rotated (plane-extended) queries + coarse gemm + the unpacked ±1
    # strip block the scan holds per tile (bf16 rows, bits·rot_dim wide)
    # + score/merge rows
    width = rot_dim * bits
    per_query = max(1, n_probes * max_list_size * (width * 2 + 8))
    qt = _ws_tile(q, per_query, ws)
    workspace = qt * per_query + q * width * 4 + q * n_lists * 8
    outputs = q * k * 8
    return operands, outputs, workspace


def _est_ivf_bq_paged(*, q, dim, n_lists, capacity_pages, page_rows,
                      table_width, n_probes, k, rot_dim=None, bits=1,
                      rotation_kind="dense", workspace_bytes=None):
    ws = workspace_bytes if workspace_bytes is not None else _workspace_bytes()
    if rot_dim is None:
        rot_dim = _auto_rot_dim_bq(dim, rotation_kind)
    operands = q * dim * 4 + _predict_paged_store(
        n_lists=n_lists, dim=dim, capacity_pages=capacity_pages,
        page_rows=page_rows, table_width=table_width,
        payload_width=bits * rot_dim // 8, payload_dtype="uint8",
        store_kind="ivf_bq", rot_dim=rot_dim, rotation_kind=rotation_kind)
    # the unpacked ±1 strip block per probed chain row + score/merge rows
    width = rot_dim * bits
    per_query = max(1, n_probes * table_width * page_rows * (width * 2 + 8))
    qt = _ws_tile(q, per_query, ws)
    workspace = qt * per_query + q * width * 4 + q * n_lists * 8
    outputs = q * k * 8
    return operands, outputs, workspace


def _est_brute_force_search(*, q, n, dim, k, tile_rows=65536,
                            dtype="float32", workspace_bytes=None):
    operands = q * dim * 4 + _predict_brute_force(n=n, dim=dim, dtype=dtype)
    tile = min(n, tile_rows)
    workspace = q * tile * 4 * 2                       # distance tile + select
    outputs = q * k * 8
    return operands, outputs, workspace


def _est_serving_upsert(*, n_rows, payload_width, dim,
                        payload_dtype="float32", extra_row_bytes=0,
                        workspace_bytes=None):
    batch = 1 << max(0, int(n_rows - 1).bit_length())  # pow2 scatter bucket
    operands = n_rows * dim * 4                        # incoming vectors
    # payload + id + aux + scan bias + kind-specific extra pool row
    workspace = batch * (payload_width * _isize(payload_dtype) + 4 + 4 + 4
                         + int(extra_row_bytes) + 16)
    outputs = 0                                        # in-place pool update
    return operands, outputs, workspace


_ESTIMATORS = {
    "ivf_flat.search": _est_ivf_flat_search,
    "ivf_flat.paged_scan": _est_ivf_flat_paged,
    "ivf_pq.search": _est_ivf_pq_search,
    "ivf_pq.paged_scan": _est_ivf_pq_paged,
    "ivf_bq.search": _est_ivf_bq_search,
    "ivf_bq.paged_scan": _est_ivf_bq_paged,
    "brute_force.search": _est_brute_force_search,
    "serving.upsert": _est_serving_upsert,
}


def estimate(entry: str, **shapes) -> dict:
    """Static footprint of ONE dispatch of ``entry``: operand bytes (the
    resident arrays the program reads), output bytes, and workspace bytes
    (the big intermediates, via the same per-query/tile arithmetic the
    dispatch site uses to size itself). ``transient_bytes`` = outputs +
    workspace — the allocation the dispatch ADDS on top of what is already
    resident, which is the number admission projects forward."""
    with obs.record_span("obs.costmodel::estimate",
                         attrs={"entry": entry} if obs.enabled() else None):
        fn = _ESTIMATORS.get(entry)
        if fn is None:
            raise ValueError(
                f"unknown entry {entry!r} (have {sorted(_ESTIMATORS)})")
        operands, outputs, workspace = fn(**shapes)
        out = {
            "entry": entry,
            "operand_bytes": int(operands),
            "output_bytes": int(outputs),
            "workspace_bytes": int(workspace),
            "transient_bytes": int(outputs + workspace),
            "total_bytes": int(operands + outputs + workspace),
        }
        if obs.enabled():
            obs.set_gauge(f"costmodel.{entry}.total_bytes",
                          out["total_bytes"])
        return out


def estimate_search(index, q: int, k: int, n_probes: int = 0,
                    workspace_bytes: Optional[int] = None,
                    filter=None) -> dict:
    """:func:`estimate` with kwargs derived from a live index/store — the
    bench-section and serving-dispatch convenience.

    ``filter`` (a :class:`~raft_tpu_torch.core.bitset.Bitset`) projects the
    footprint of the plan the dispatch will ACTUALLY run: the families
    widen ``n_probes`` by the selectivity factor
    (``neighbors/_filtering.widen_plan``) before scanning, so a filtered
    estimate widens here with the same rule — predicted-vs-measured
    stays exact under push-down."""
    layout = index_layout(index)
    kind = layout.pop("kind")
    if filter is not None and n_probes:
        from raft_tpu_torch.neighbors import _filtering
        n_probes, _, _, _ = _filtering.widen_plan(
            filter, n_probes, layout.get("n_lists", n_probes))
    ws = {"workspace_bytes": workspace_bytes}
    if kind == "ivf_flat":
        return estimate("ivf_flat.search", q=q, k=k, n_probes=n_probes,
                        dim=layout["dim"], n_lists=layout["n_lists"],
                        max_list_size=layout["max_list_size"],
                        dtype=layout["dtype"], norms=layout["norms"], **ws)
    if kind == "ivf_pq":
        return estimate("ivf_pq.search", q=q, k=k, n_probes=n_probes,
                        dim=layout["dim"], n_lists=layout["n_lists"],
                        max_list_size=layout["max_list_size"],
                        pq_dim=layout["pq_dim"], pq_bits=layout["pq_bits"],
                        rot_dim=layout["rot_dim"], **ws)
    if kind == "ivf_bq":
        return estimate("ivf_bq.search", q=q, k=k, n_probes=n_probes,
                        dim=layout["dim"], n_lists=layout["n_lists"],
                        max_list_size=layout["max_list_size"],
                        rot_dim=layout["rot_dim"],
                        bits=layout.get("bits", 1),
                        rotation_kind=layout.get("rotation_kind", "dense"),
                        **ws)
    if kind == "brute_force":
        return estimate("brute_force.search", q=q, k=k, n=layout["n"],
                        dim=layout["dim"], dtype=layout["dtype"], **ws)
    if kind == "paged_store":
        sk = layout.get("store_kind")
        entry = {"ivf_pq": "ivf_pq.paged_scan",
                 "ivf_bq": "ivf_bq.paged_scan"}.get(sk,
                                                    "ivf_flat.paged_scan")
        kw = dict(q=q, k=k, n_probes=n_probes, dim=layout["dim"],
                  n_lists=layout["n_lists"],
                  capacity_pages=layout["capacity_pages"],
                  page_rows=layout["page_rows"],
                  table_width=layout["table_width"], **ws)
        if entry == "ivf_pq.paged_scan":
            kw.update(pq_dim=layout["pq_dim"], pq_bits=layout["pq_bits"],
                      rot_dim=layout["rot_dim"])
        elif entry == "ivf_bq.paged_scan":
            kw.update(rot_dim=layout["rot_dim"],
                      bits=layout.get("bits", 1),
                      rotation_kind=layout.get("rotation_kind", "dense"))
        return estimate(entry, **kw)
    raise ValueError(f"no dispatch estimator for index family {kind!r}")


def paged_scan_estimator(store, k: int, n_probes: int):
    """``batch_size -> estimate dict`` closed over one store's CURRENT
    capacity layout — the ``QueryQueue(cost_model=...)`` hook. Re-reads
    the layout each call, so a capacity growth is priced from the next
    dispatch on."""

    def cost(batch: int) -> dict:
        return estimate_search(store, q=int(batch), k=k, n_probes=n_probes)

    return cost


# ---------------------------------------------------------------------------
# XLA cross-check
# ---------------------------------------------------------------------------


def xla_memory_analysis(jitted, *args, **kwargs) -> Optional[dict]:
    """The compiler's own byte accounting of one lowering, where a
    compiler offers it. The port runs eager PyTorch and hand-written CUDA
    kernels with no XLA behind them, so this returns None and records the
    classified ``costmodel_xla_analysis_unavailable`` event — the JAX
    package's answer on a backend without the analysis. The static model
    stands alone."""
    from raft_tpu_torch import resilience

    with obs.record_span("obs.costmodel::xla_memory_analysis"), \
            obs_compile.suppress_analysis():
        err = NotImplementedError(
            "no XLA compiler behind the port: eager PyTorch and CUDA "
            "kernels have no memory_analysis")
        resilience.record_event(
            "costmodel_xla_analysis_unavailable",
            kind=resilience.classify(err), error=repr(err)[:200])
        return None


# ---------------------------------------------------------------------------
# pre-dispatch admission
# ---------------------------------------------------------------------------


def admission_counts(counters: dict) -> dict:
    """``{verdict: count}`` folded out of a counters snapshot — the ONE
    definition of the verdict-counter namespace, shared by
    ``obs.report.collect`` and the bench operating-point record."""
    return {k[len(ADMISSION_COUNTER_PREFIX):]: int(v)
            for k, v in (counters or {}).items()
            if k.startswith(ADMISSION_COUNTER_PREFIX)}


def hbm_budget() -> dict:
    """``{"bytes": int, "source": str}`` — the denominator admission
    projects against: ``RAFT_TPU_OBS_HBM_BYTES`` when set (tests, CPU
    serving hosts), else the sum of the cards' totals
    (``obs.memory.device_stats`` ``bytes_limit``, from
    ``torch.cuda.mem_get_info``, read only where a CUDA context exists),
    else 0 with ``source="unknown"``."""
    raw = os.environ.get(HBM_ENV, "").strip()
    if raw.isdigit() and int(raw) > 0:
        return {"bytes": int(raw), "source": "env"}
    total = 0
    for dev in obs_memory.device_stats():
        total += int(dev.get("bytes_limit", 0) or 0)
    if total > 0:
        return {"bytes": total, "source": "device_stats"}
    return {"bytes": 0, "source": "unknown"}


def check_admission(predicted, entry: str = "",
                    budget_bytes: Optional[int] = None,
                    bytes_in_use: Optional[int] = None) -> dict:
    """Pre-dispatch admission verdict for a predicted footprint:
    ``predicted`` is an :func:`estimate` dict (its ``transient_bytes`` is
    the projected delta) or a plain byte count. Projects ``bytes_in_use +
    predicted`` against the budget and classifies ADMIT (≤ soft·budget) /
    QUEUE (≤ hard·budget) / REJECT — recorded as gauges
    (``costmodel.admission.*``) and, for non-admit verdicts, classified
    events in the resilience ring. On a multi-device backend with
    per-device allocator limits the verdict is the WORST device's: the
    whole predicted footprint is projected onto each device's own
    ``(bytes_in_use + predicted) / bytes_limit`` — summing across devices
    would dilute one hot chip's pressure by the device count and admit
    the dispatch that OOMs it. Returns the verdict record; NEVER raises
    (an admission check that throws is worse than no check — failures
    degrade to an ``unknown``-budget ADMIT, classified).

    ``bytes_in_use`` overrides the live watermark sample —
    the per-tenant residency budgeter projects against its own PREDICTED
    resident ledger (deterministic, synthetic-budget friendly) instead
    of whatever else the process happens to hold. QUEUE/REJECT records
    carry ``shortfall_bytes`` = ``projected − soft·budget`` — the exact
    number of bytes an eviction must free to return the projection to
    ADMIT, so the capacity controller sizes demotions instead of
    guessing."""
    from raft_tpu_torch import resilience

    with obs.record_span("obs.costmodel::check_admission",
                         attrs={"entry": entry} if obs.enabled() else None):
        try:
            if isinstance(predicted, dict):
                pred_bytes = int(predicted.get(
                    "transient_bytes", predicted.get("total_bytes", 0)))
            else:
                pred_bytes = int(predicted)
        except Exception as e:
            # a malformed prediction must not cost the dispatch either:
            # zero-byte ADMIT, classified — the caller's hook is broken,
            # not the request
            resilience.record_event("admission_bad_prediction",
                                    kind=resilience.classify(e),
                                    error=repr(e)[:200])
            pred_bytes = 0
        per_dev = []
        try:
            if bytes_in_use is not None:
                # the budgeter's ledger IS the watermark: no sampling, no
                # per-device dilution — one deterministic projection
                in_use = int(bytes_in_use)
            else:
                mem = obs_memory.sample(f"admission.{entry}" if entry
                                        else "admission")
                in_use = int(mem["bytes_in_use"])
                per_dev = [d for d in (mem.get("per_device") or [])
                           if d.get("bytes_limit")]
            budget = ({"bytes": int(budget_bytes), "source": "caller"}
                      if budget_bytes else hbm_budget())
        except Exception as e:
            # the check must not cost the dispatch: degrade classified
            resilience.record_event("admission_check_error",
                                    kind=resilience.classify(e),
                                    error=repr(e)[:200])
            in_use, budget = 0, {"bytes": 0, "source": "unknown"}
        projected = in_use + pred_bytes
        soft, hard = _frac(SOFT_ENV, 0.85), _frac(HARD_ENV, 0.97)
        shortfall = None
        if budget["source"] == "device_stats" and per_dev:
            # worst-device projection (see docstring)
            frac = max((d["bytes_in_use"] + pred_bytes) / d["bytes_limit"]
                       for d in per_dev)
            verdict = (ADMIT if frac <= soft
                       else QUEUE if frac <= hard else REJECT)
            shortfall = max(d["bytes_in_use"] + pred_bytes
                            - soft * d["bytes_limit"] for d in per_dev)
        elif budget["bytes"] <= 0:
            verdict, frac = ADMIT, None
        else:
            frac = projected / budget["bytes"]
            verdict = (ADMIT if frac <= soft
                       else QUEUE if frac <= hard else REJECT)
            shortfall = projected - soft * budget["bytes"]
        rec = {
            "verdict": verdict,
            "entry": entry,
            "predicted_bytes": pred_bytes,
            "bytes_in_use": in_use,
            "projected_bytes": projected,
            "budget_bytes": budget["bytes"],
            "budget_source": budget["source"],
            "projected_fraction": (round(frac, 4)
                                   if frac is not None else None),
            "t": round(time.time(), 3),
        }
        if verdict != ADMIT and shortfall is not None:
            # the eviction size: free this many bytes and the projection
            # is back under the soft threshold (capacity controller input)
            rec["shortfall_bytes"] = int(np.ceil(max(0.0, shortfall)))
        if obs.enabled():
            obs.add(f"{ADMISSION_COUNTER_PREFIX}{verdict}")
            obs.set_gauge("costmodel.admission.predicted_bytes", pred_bytes)
            obs.set_gauge("costmodel.admission.projected_bytes", projected)
        if verdict != ADMIT:
            resilience.record_event(f"admission_{verdict}", entry=entry,
                                    predicted_bytes=pred_bytes,
                                    projected_bytes=projected,
                                    budget_bytes=budget["bytes"])
        return rec
