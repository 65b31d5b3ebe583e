"""IVF-Flat: inverted lists of uncompressed vectors (counterpart of
``raft_tpu/neighbors/ivf_flat.py``).

Lists are padded dense blocks: one (n_lists, max_list_size, dim) array
with ``list_ids == -1`` at padding, balanced k-means bounding the skew.
Integer datasets (uint8 / int8, the on-disk formats of the big ANN sets)
are stored in their own dtype; the scan rounds both operands to bf16, which
is exact for integers up to 256 in magnitude.

Search has two backends (:func:`resolve_backend` picks one for
``"auto"``). ``"ragged"`` is the strip scan of
:mod:`raft_tpu_torch.ops.strip_scan`: one coarse gemm picks each query's
``n_probes`` lists, kernel K1 scores ``−2⟨q, x⟩ + ‖x‖²`` (L2) or
``−⟨q, x⟩`` (inner product, cosine on normalized rows) over the probed
lists and keeps each pair's top-k, and the merge picks the query's top-k.
``"gather"`` is the reference's exact-fp32 path in plain torch: the probed
lists gathered per query tile, one einsum, a stable select over every
probed entry; it serves any list length and any k. :func:`search_paged`
runs the strip search over a :class:`raft_tpu_torch.serving.PagedListStore`,
whose pages kernel K3 scans in place, or the same gather over the page
table where K3's plan cannot feed k.

``filter`` (a :class:`raft_tpu_torch.core.bitset.Bitset` over source ids)
is one more bias operand on the strip paths (+inf where an id fails,
:mod:`raft_tpu_torch.neighbors._filtering`) and a validity mask on the
gather paths; n_probes widens by the filter's selectivity. :func:`extend`
assigns new rows to the fixed centers and repacks.

Telemetry and fault injection are the JAX package's: ``ivf_flat::build``
(phases ``coarse_train``, ``pack``), ``ivf_flat::search`` →
``ivf_flat::scan`` and ``ivf_flat::search_paged`` → ``paged_pallas`` (K3)
or ``paged_scan`` (gather) spans; ``ivf_flat.search.*`` /
``ivf_flat.search_paged.*`` counters; the ``ivf_flat.search.filter``,
``.search.scan`` and ``.search_paged.scan`` faultpoints.
"""

from __future__ import annotations

import contextlib
import logging
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.core.serialize import load_arrays, save_arrays
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.neighbors import _filtering, _packing
from raft_tpu_torch.obs import compile as obs_compile
from raft_tpu_torch.obs import roofline as obs_roofline
from raft_tpu_torch.obs.costmodel import dtype_name
from raft_tpu_torch.ops import strip_scan as ss
from raft_tpu_torch.ops.distance import (canonical_metric,
                                         expanded_sqeuclidean, matmul_t,
                                         sqnorm)
from raft_tpu_torch.ops.select_k import select_k
from raft_tpu_torch.resilience import faultpoint

SUPPORTED_METRICS = ("sqeuclidean", "euclidean", "inner_product", "cosine")
BACKENDS = ("auto", "ragged", "gather")
PAGED_BACKENDS = ("auto", "paged", "gather")

_log = logging.getLogger("raft_tpu_torch")


@dataclass(frozen=True)
class IvfFlatParams:
    """Build params. ``list_size_cap``: per-list occupancy cap, -1 auto (4×
    the mean, group-aligned), 0 off; overflow rows spill to their next
    nearest lists. ``group_size``: list padding granule, 0 auto (512, the
    strip granule, when the mean list is large enough, else 64)."""

    n_lists: int = 1024
    metric: str = "sqeuclidean"
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    list_size_cap: int = -1
    group_size: int = 0
    seed: int = 0

    def __post_init__(self):
        m = canonical_metric(self.metric)
        if m not in SUPPORTED_METRICS:
            raise ValueError(f"ivf_flat supports {SUPPORTED_METRICS}, got {self.metric!r}")
        object.__setattr__(self, "metric", m)


@dataclass
class IvfFlatIndex:
    """Cluster centers and padded per-list vector blocks. ``list_norms``
    caches each entry's squared L2 norm for the L2 metrics. For cosine,
    vectors and centers are stored L2-normalized and the scan runs as inner
    product."""

    centers: torch.Tensor              # (n_lists, dim) fp32
    list_data: torch.Tensor            # (n_lists, m, dim) dataset dtype
    list_ids: torch.Tensor             # (n_lists, m) int32, -1 = padding
    list_norms: Optional[torch.Tensor]  # (n_lists, m) fp32, L2 only
    metric: str = "sqeuclidean"
    group_size: int = 0
    _lens_np_cache: Optional[np.ndarray] = field(default=None, repr=False)
    _ragged_static_cache: Any = field(default=None, repr=False)

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def max_list_size(self) -> int:
        return self.list_data.shape[1]

    @property
    def device(self) -> torch.device:
        return self.centers.device

    @property
    def size(self) -> int:
        return int((self.list_ids >= 0).sum())

    def list_sizes(self) -> torch.Tensor:
        return (self.list_ids >= 0).sum(dim=1).to(torch.int32)

    def to(self, device: DeviceLike) -> "IvfFlatIndex":
        """A copy of the index with its tensors on ``device``."""
        dev = torch.device(device)
        return IvfFlatIndex(
            self.centers.to(dev), self.list_data.to(dev),
            self.list_ids.to(dev),
            None if self.list_norms is None else self.list_norms.to(dev),
            self.metric, self.group_size)

    def arrays(self) -> Dict[str, torch.Tensor]:
        out = {"centers": self.centers, "list_data": self.list_data,
               "list_ids": self.list_ids}
        if self.list_norms is not None:
            out["list_norms"] = self.list_norms
        return out

    def meta(self) -> Dict[str, Any]:
        return {"kind": "ivf_flat", "metric": self.metric,
                "group_size": self.group_size}

    def save(self, path) -> None:
        """Write the v2 container both packages read."""
        save_arrays(path, self.meta(), self.arrays())

    @classmethod
    def load(cls, path, device: Optional[DeviceLike] = None,
             res: Optional[Resources] = None) -> "IvfFlatIndex":
        """Read an ``ivf_flat`` container written by either package."""
        meta, arrays = load_arrays(path)
        return from_jax_arrays(meta, arrays, device=device, res=res)


def from_jax_arrays(meta: Mapping[str, Any], arrays: Mapping[str, Any],
                    device: Optional[DeviceLike] = None,
                    res: Optional[Resources] = None) -> IvfFlatIndex:
    """An index from the JAX package's arrays (``centers``, ``list_data``,
    ``list_ids`` and, for L2, ``list_norms``, as numpy or anything
    ``np.asarray`` takes) and its container meta."""
    if meta.get("kind", "ivf_flat") != "ivf_flat":
        raise ValueError(f"not an ivf_flat index: {meta.get('kind')}")
    dev = resources_for(device, res).device

    def t(name):
        return torch.from_numpy(np.array(arrays[name])).to(dev)

    return IvfFlatIndex(
        t("centers"), t("list_data"), t("list_ids"),
        t("list_norms") if arrays.get("list_norms") is not None else None,
        meta.get("metric", "sqeuclidean"), int(meta.get("group_size", 0)))


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------


def _pack_lists(dataset, row_ids, labels, n_lists: int, group: int = 0):
    """Padded per-list blocks, rows in arrival order; power-of-two chunk
    counts at the strip granule (512)."""
    if group <= 0:
        group = _packing.auto_group_size(dataset.shape[0], n_lists)
    return _packing.pack_lists(dataset, row_ids, labels, n_lists, group,
                               pow2_chunks=group == 512)


@traced("ivf_flat::build")
def build(dataset, params: IvfFlatParams = IvfFlatParams(),
          res: Optional[Resources] = None,
          device: Optional[DeviceLike] = None) -> IvfFlatIndex:
    """Train the coarse quantizer (balanced k-means on a
    ``kmeans_trainset_fraction`` sample) and fill the lists. Integer
    datasets keep their dtype (except under cosine, which stores the
    normalized rows)."""
    res = resources_for(device, res)
    dev = res.device
    data = torch.as_tensor(dataset).to(dev)
    n, dim = data.shape
    if params.n_lists > n:
        raise ValueError(f"n_lists={params.n_lists} > n_rows={n}")
    work = data.to(torch.float32)
    if params.metric == "cosine":
        work = work / torch.clamp(torch.linalg.vector_norm(work, dim=1,
                                                           keepdim=True),
                                  min=1e-30)
    km_metric = ("inner_product" if params.metric in ("cosine", "inner_product")
                 else "sqeuclidean")
    km = kmeans_balanced.KMeansBalancedParams(
        n_iters=params.kmeans_n_iters, metric=km_metric, seed=params.seed)
    (g_train,) = kmeans_balanced.seeded_generators(params.seed, 1, dev)
    n_train = max(params.n_lists, int(n * params.kmeans_trainset_fraction))
    with obs.record_span("ivf_flat::coarse_train"):
        if n_train < n:
            rows = torch.randint(0, n, (n_train,), generator=g_train,
                                 device=dev)
            centers = kmeans_balanced.fit(work[rows], params.n_lists, km,
                                          res=res)
            labels = kmeans_balanced.predict(work, centers, km, res=res)
        else:
            centers, labels = kmeans_balanced.fit_predict(
                work, params.n_lists, km, res=res)
    if obs.enabled():
        obs.add("ivf_flat.build.rows", n)
        obs.add("ivf_flat.build.lists", params.n_lists)
    group = params.group_size or _packing.auto_group_size(n, params.n_lists)
    cap = params.list_size_cap
    if cap < 0:
        cap = _packing.auto_list_cap(n, params.n_lists, group)
    if cap:
        labels = _packing.spill_to_cap(work, centers, labels, km_metric, cap)
    integer = not data.is_floating_point() and params.metric != "cosine"
    store = data if integer else work
    row_ids = torch.arange(n, dtype=torch.int32, device=dev)
    with obs.record_span("ivf_flat::pack"):
        list_data, list_ids = _pack_lists(store, row_ids, labels,
                                          params.n_lists, group)
        list_norms = None
        if params.metric in ("sqeuclidean", "euclidean"):
            list_norms = sqnorm(list_data, dim=2)
    return IvfFlatIndex(centers, list_data, list_ids, list_norms,
                        params.metric, group)


@traced("ivf_flat::extend")
def extend(index: IvfFlatIndex, new_vectors, new_ids=None,
           res: Optional[Resources] = None,
           device: Optional[DeviceLike] = None) -> IvfFlatIndex:
    """Add rows to an index → a new index: the rows go to their nearest
    fixed center, spill under the auto cap on top of each list's fill (at
    the index's granule; legacy indexes infer it) and the lists are
    repacked. Integer storage stays integer (rounded and clipped, with a
    warning when that moves a component by more than 0.5). Ids default to
    ``max + 1 …``."""
    res = resources_for(device, res)
    if index.device != res.device:
        raise ValueError(f"index lives on {index.device}, extend runs on "
                         f"{res.device}; move it with index.to(device)")
    X = torch.as_tensor(new_vectors).to(device=res.device, dtype=torch.float32)
    if X.ndim != 2 or X.shape[1] != index.dim:
        raise ValueError(f"new_vectors must be (n, {index.dim}), got "
                         f"{tuple(X.shape)}")
    if index.metric == "cosine":
        X = X / torch.clamp(torch.linalg.vector_norm(X, dim=1, keepdim=True),
                            min=1e-30)
    old_vecs, old_ids, old_labels = _packing.unpack_lists(index.list_data,
                                                          index.list_ids)
    if new_ids is None:
        start = int(old_ids.max()) + 1 if old_ids.numel() else 0
        new_ids = torch.arange(start, start + X.shape[0], dtype=torch.int32,
                               device=X.device)
    else:
        new_ids = torch.as_tensor(new_ids).to(X.device, torch.int32)
    km_metric = ("inner_product" if index.metric in ("cosine", "inner_product")
                 else "sqeuclidean")
    labels = kmeans_balanced.predict(
        X, index.centers, kmeans_balanced.KMeansBalancedParams(
            metric=km_metric), res=res)
    group = index.group_size or (512 if index.max_list_size % 512 == 0
                                 else 64)
    cap = _packing.auto_list_cap(old_ids.shape[0] + X.shape[0],
                                 index.n_lists, group)
    labels = _packing.spill_to_cap(X, index.centers, labels, km_metric, cap,
                                   base_counts=index.list_sizes())
    dtype = index.list_data.dtype
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        new_store = torch.clamp(torch.round(X), info.min, info.max).to(dtype)
        err = float((new_store.to(torch.float32) - X).abs().max()) \
            if X.numel() else 0.0
        if err > 0.5:
            _log.warning(
                "ivf_flat.extend: quantizing float vectors into %s storage "
                "loses up to %.3g per component (out-of-range or fractional "
                "inputs); rebuild with fp32 storage if that matters",
                dtype, err)
    else:
        new_store = X.to(dtype)
    list_data, list_ids = _pack_lists(
        torch.cat([old_vecs, new_store]), torch.cat([old_ids, new_ids]),
        torch.cat([old_labels.to(torch.int64), labels.to(torch.int64)]),
        index.n_lists, group)
    list_norms = None
    if index.metric in ("sqeuclidean", "euclidean"):
        list_norms = sqnorm(list_data, dim=2)
    return IvfFlatIndex(index.centers, list_data, list_ids, list_norms,
                        index.metric, group)


def split_list_rows(rows, n_iter: int = 8):
    """Deterministic 2-means split of one overfull list's rows: seeds are
    the two extreme rows along the max-variance coordinate, then a few
    Lloyd rounds on the host (one list is small, and no RNG keeps the
    split reproducible). Returns ``(centers (2, dim) float32, assign (n,)
    int32)``; identical rows collapse onto one side."""
    rows = np.asarray(rows, np.float32)
    if rows.ndim != 2 or rows.shape[0] < 2:
        raise ValueError("split_list_rows needs a (n >= 2, dim) row matrix")
    mu = rows.mean(axis=0)
    coord = rows[:, int(((rows - mu) ** 2).mean(axis=0).argmax())]
    centers = np.stack([rows[int(coord.argmin())], rows[int(coord.argmax())]])
    assign = np.zeros(rows.shape[0], np.int32)
    for it in range(max(1, int(n_iter))):
        d0 = ((rows - centers[0]) ** 2).sum(axis=1)
        d1 = ((rows - centers[1]) ** 2).sum(axis=1)
        new = (d1 < d0).astype(np.int32)
        if it > 0 and np.array_equal(new, assign):
            break
        assign = new
        for side in (0, 1):
            sel = rows[assign == side]
            if sel.shape[0]:
                centers[side] = sel.mean(axis=0)
    return centers, assign


# ---------------------------------------------------------------------------
# Search (the "ragged" strip backend)
# ---------------------------------------------------------------------------


def _lens_np(index) -> np.ndarray:
    """Per-list entry counts on the host, cached on the index: planning
    needs them every search and a refetch would sync the device."""
    cached = getattr(index, "_lens_np_cache", None)
    if cached is None or cached.shape[0] != index.n_lists:
        cached = index.list_sizes().cpu().numpy()
        index._lens_np_cache = cached
    return cached


def _coarse_probes(queries, centers, n_probes: int, metric: str,
                   select_algo: str = "exact",
                   compute_dtype: Optional[torch.dtype] = None):
    """Each query's ``n_probes`` nearest lists (q, p) int32: expanded L2
    (clamped at 0) or the negated inner product, from one fp32 gemm."""
    ip = matmul_t(queries, centers, compute_dtype)
    if metric in ("sqeuclidean", "euclidean"):
        coarse = torch.clamp(sqnorm(queries)[:, None] + sqnorm(centers)[None, :]
                             - 2.0 * ip, min=0.0)
    else:
        coarse = -ip
    _, probes = select_k(coarse, n_probes, select_min=True, algo=select_algo)
    return probes


def _ragged_bias(list_ids, list_norms, mode: str):
    """Per-entry additive term of the scan: ‖x‖² for L2, 0 for ip/cosine;
    +inf at padding."""
    base = (list_norms if mode == "l2"
            else torch.zeros(list_ids.shape, dtype=torch.float32,
                             device=list_ids.device))
    return torch.where(list_ids >= 0, base.to(torch.float32),
                       float("inf")).contiguous()


def _finalize_ragged(vals: torch.Tensor, ids: torch.Tensor,
                     queries: torch.Tensor, metric: str):
    """Strip-scan scores → distances: add ‖q‖² back for L2 (clamped at 0,
    square-rooted for euclidean), ``1 + v`` for cosine, ``-v`` for inner
    product; ±inf where the id is -1."""
    inf = torch.full_like(vals, float("inf"))
    if metric in ("sqeuclidean", "euclidean"):
        vals = torch.clamp(vals + sqnorm(queries)[:, None], min=0.0)
        if metric == "euclidean":
            vals = torch.sqrt(vals)
        return torch.where(ids >= 0, vals, inf), ids
    if metric == "cosine":
        return torch.where(ids >= 0, 1.0 + vals, inf), ids
    return torch.where(ids >= 0, -vals, -inf), ids


def _ragged_plan_static(index, n_probes: int, k: int, res, dim: int):
    """Length classes, per-class list counts, the device class ordinals
    (cached on the index: they depend only on list lengths) and the query
    tile for this search."""
    cached = getattr(index, "_ragged_static_cache", None)
    if cached is None:
        classes, cls_ord_np = ss.class_info(_lens_np(index), dim=dim)
        classes = tuple(classes)
        cached = (classes, ss.class_counts_of(cls_ord_np, len(classes)),
                  torch.as_tensor(cls_ord_np, device=index.centers.device))
        index._ragged_static_cache = cached
    classes, class_counts, cls_ord = cached
    q_tile = ss.fit_q_tile(1 << 30, n_probes, index.n_lists, len(classes),
                           int(k), res.workspace_bytes, dim=dim,
                           class_counts=class_counts)
    return classes, class_counts, cls_ord, q_tile


def _ragged_fused(queries, index: IvfFlatIndex, bias, k: int, n_probes: int,
                  select_algo: str, res: Resources, classes, class_counts,
                  cls_ord, q_tile: int, gathered: bool = False):
    """Coarse gemm, device strip plan, K1 over the probed lists (on the
    gathered walk with ``gathered``), merge and finalize."""
    obs_compile.trace_event(
        "ivf_flat.search_ragged", queries=queries, centers=index.centers,
        list_data=index.list_data, bias=bias, list_ids=index.list_ids,
        cls_ord=cls_ord,
        static={"k": k, "n_probes": n_probes, "metric": index.metric,
                "select_algo": select_algo,
                "compute_dtype": res.compute_dtype, "classes": classes,
                "class_counts": class_counts, "q_tile": q_tile})
    probes = _coarse_probes(queries, index.centers, n_probes, index.metric,
                            select_algo, res.compute_dtype)
    l2 = index.metric in ("sqeuclidean", "euclidean")
    vals, ids = ss.strip_search_traced(
        queries, probes, index.list_data, bias, index.list_ids, cls_ord,
        classes, class_counts, int(k), int(k), -2.0 if l2 else -1.0, q_tile,
        gathered=gathered)
    return _finalize_ragged(vals, ids, queries, index.metric)


def _search_ragged(index: IvfFlatIndex, queries, k: int, n_probes: int,
                   select_algo: str, res: Resources, filter=None):
    """The strip path: work follows the probed lists' real entries, each
    pair's top-k kept inside K1. The bias is the list norms (L2) or zeros,
    +inf at padding; a filter turns its failing ids' lanes to +inf and puts
    K1 on its gathered walk."""
    l2 = index.metric in ("sqeuclidean", "euclidean")
    # made per search, not cached: the index holds exactly the fields
    # obs.costmodel.predict_index_bytes counts
    bias = _filtering.apply_filter_bias(
        _ragged_bias(index.list_ids, index.list_norms, "l2" if l2 else "ip"),
        index.list_ids, filter)
    classes, class_counts, cls_ord, q_tile = _ragged_plan_static(
        index, n_probes, k, res, index.dim)
    return _ragged_fused(queries, index, bias, int(k), n_probes,
                         select_algo, res, classes, class_counts, cls_ord,
                         min(q_tile, queries.shape[0]),
                         filter is not None)


def _prep_queries(queries, dim: int, metric: str, dev: torch.device):
    queries = torch.as_tensor(queries).to(device=dev, dtype=torch.float32)
    if queries.ndim != 2 or queries.shape[1] != dim:
        raise ValueError(f"queries must be (q, {dim}), got {tuple(queries.shape)}")
    if metric == "cosine":
        queries = queries / torch.clamp(
            torch.linalg.vector_norm(queries, dim=1, keepdim=True), min=1e-30)
    return queries


def _gather_scan(queries, centers, metric: str, k: int, n_probes: int,
                 select_algo: str, res: Resources, cols: int, gather,
                 filter=None):
    """The gather scan (the JAX package's ``_search_impl`` and paged
    ``_paged_impl``): the coarse select at full fp32, then per query tile
    the probed candidates gathered by ``gather(probes) → (rows (qt, p,
    cols, dim), ids (qt, p, cols), norms (qt, p, cols) or None)``, one
    fp32 einsum, the metric's norm terms, ids that are -1 or fail
    ``filter`` masked, and a stable select over all p·cols entries. The
    tile keeps the gather under ``res.workspace_bytes``."""
    q, dim = queries.shape
    l2 = metric in ("sqeuclidean", "euclidean")
    select_min = metric != "inner_product"
    bad = float("inf") if select_min else float("-inf")
    if l2:
        coarse = expanded_sqeuclidean(queries, centers, res.compute_dtype)
    else:       # cosine (normalized) and inner product probe by max ip
        coarse = -matmul_t(queries, centers, res.compute_dtype)
    _, probes = select_k(coarse, n_probes, select_min=True, algo=select_algo)
    per_query = max(1, n_probes * cols * (dim + 2) * 4)
    q_tile = int(max(1, min(q, res.workspace_bytes // per_query)))
    outs = []
    for s in range(0, q, q_tile):
        q_blk = queries[s:s + q_tile]
        rows, ids, norms = gather(probes[s:s + q_tile].to(torch.int64))
        ip = torch.einsum("qd,qpmd->qpm", q_blk, rows.to(torch.float32))
        if l2:
            d = torch.clamp(sqnorm(q_blk)[:, None, None] + norms - 2.0 * ip,
                            min=0.0)
            if metric == "euclidean":
                d = torch.sqrt(d)
        elif metric == "cosine":
            d = 1.0 - ip
        else:
            d = ip
        flat_ids = ids.reshape(ids.shape[0], -1)
        valid = flat_ids >= 0
        if filter is not None:
            valid = valid & filter.test(flat_ids)
        d = torch.where(valid, d.reshape(flat_ids.shape), bad)
        vals, sel = select_k(d, k, select_min=select_min, algo=select_algo)
        out_ids = torch.gather(flat_ids, 1, sel.to(torch.int64))
        outs.append((vals, torch.where(vals == bad, -1, out_ids)))
    return torch.cat([v for v, _ in outs]), torch.cat([i for _, i in outs])


def _search_gather(index: IvfFlatIndex, queries, k: int, n_probes: int,
                   select_algo: str, res: Resources, filter=None):
    """The gather backend over the padded lists."""
    l2 = index.metric in ("sqeuclidean", "euclidean")
    obs_compile.trace_event(
        "ivf_flat.search", queries=queries, centers=index.centers,
        list_data=index.list_data, list_ids=index.list_ids,
        list_norms=index.list_norms, filter=filter,
        static={"k": k, "n_probes": n_probes, "metric": index.metric,
                "select_algo": select_algo,
                "compute_dtype": res.compute_dtype})

    def gather(pb):
        return (index.list_data[pb], index.list_ids[pb],
                index.list_norms[pb] if l2 else None)

    return _gather_scan(queries, index.centers, index.metric, k, n_probes,
                        select_algo, res, index.max_list_size, gather, filter)


def resolve_backend(backend: str, device_type: str, max_list_size: int,
                    k: int) -> str:
    """The backend :func:`search` runs for an index on ``device_type``.
    ``"auto"`` on ``cuda``: ``"ragged"`` (K1) when ``max_list_size`` is a
    power-of-two multiple of 512 and k ≤ 512, else ``"gather"``; on the
    CPU, ``"gather"``, as the JAX package's ``auto`` gives off the TPU. An
    explicit ``"ragged"`` the strip plan cannot feed raises ``ValueError``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of "
                         f"{BACKENDS})")
    aligned = ss.strip_eligible(max_list_size) and k <= 512
    if backend == "auto":
        return "ragged" if device_type == "cuda" and aligned else "gather"
    if backend == "ragged" and not aligned:
        raise ValueError(
            f"ragged backend needs max_list_size = a power-of-two multiple of "
            f"512 and k <= 512, got {max_list_size} / k={k}; rebuild with "
            "group_size=512 (or use backend='gather')")
    return backend


def _scan_telemetry(prefix: str, backend: str, q: int, n_probes: int, k: int,
                    filter_attrs: Optional[dict] = None,
                    rows_scanned: Optional[int] = None, **extra) -> dict:
    """Count one search under ``prefix`` (``<prefix>.queries``,
    ``.probes``, ``.rows_scanned`` when given, ``.backend.<backend>``) and
    return its scan span's attributes. Called only under
    ``obs.enabled()``."""
    obs.add(f"{prefix}.queries", q)
    obs.add(f"{prefix}.probes", q * n_probes)
    if rows_scanned is not None:
        # padded upper bound on candidate rows visited (telemetry, not
        # billing)
        obs.add(f"{prefix}.rows_scanned", rows_scanned)
    obs.add(f"{prefix}.backend.{backend}", 1)
    attrs = {"backend": backend, "queries": q, "probes": int(n_probes),
             "k": int(k), **extra}
    if filter_attrs:
        attrs.update(filter_attrs)
    return attrs


def _filter_plan(site: str, filter, n_probes: int, n_lists: int):
    """A search's filter step → (n_probes, filter span attributes or
    None): the ``site`` faultpoint and the selectivity widening, for a
    filtered search; ``(n_probes, None)`` without a filter."""
    if filter is None:
        return n_probes, None
    faultpoint(site)
    n_probes, _, rate, widen = _filtering.widen_plan(filter, n_probes,
                                                     n_lists)
    return n_probes, {"filter_pass_rate": round(rate, 6),
                      "filter_widen_x": round(widen, 4),
                      "filter_n_probes": n_probes}


@traced("ivf_flat::search")
def search(index: IvfFlatIndex, queries, k: int, n_probes: int = 20,
           filter=None, select_algo: str = "exact", backend: str = "auto",
           res: Optional[Resources] = None,
           device: Optional[DeviceLike] = None):
    """Probe ``n_probes`` lists per query and return the top-k →
    (distances (q, k) fp32, ids (q, k) int32, -1 where fewer than k valid
    candidates were found). ``backend``: "ragged" (the strip scan through
    K1), "gather" (plain torch, exact fp32) or "auto"
    (:func:`resolve_backend`). ``filter``: a
    :class:`~raft_tpu_torch.core.bitset.Bitset` over source ids; rows whose
    id fails never come back, and n_probes widens by its selectivity
    (:func:`_filtering.widen_plan`)."""
    res = resources_for(device, res)
    if index.device != res.device:
        raise ValueError(f"index lives on {index.device}, search runs on "
                         f"{res.device}; move it with index.to(device)")
    n_probes = int(min(n_probes, index.n_lists))
    n_probes, filter_attrs = _filter_plan("ivf_flat.search.filter", filter,
                                          n_probes, index.n_lists)
    if not 0 < k <= n_probes * index.max_list_size:
        raise ValueError(
            f"k={k} out of range for n_probes={n_probes} x "
            f"max_list_size={index.max_list_size}")
    backend = resolve_backend(backend, res.device.type, index.max_list_size,
                              int(k))
    queries = _prep_queries(queries, index.dim, index.metric, res.device)
    scan_attrs = None
    if obs.enabled():
        q = int(queries.shape[0])
        scan_attrs = _scan_telemetry(
            "ivf_flat.search", backend, q, n_probes, k, filter_attrs,
            rows_scanned=q * n_probes * index.max_list_size)
        # the dispatch's static FLOP/byte model, with the strip planner's
        # occupancy when the host already holds the list lengths
        occ = None
        lens_cached = getattr(index, "_lens_np_cache", None)
        if backend == "ragged" and lens_cached is not None \
                and lens_cached.shape[0] == index.n_lists:
            kf_occ = min(int(k), 512)
            occ = obs_roofline.memo_occupancy(
                index,
                (id(lens_cached), q, int(n_probes), kf_occ,
                 res.workspace_bytes),
                lambda: ss.occupancy_stats(
                    lens_cached, index.max_list_size, q, n_probes,
                    dim=index.dim, workspace_bytes=res.workspace_bytes,
                    kf=kf_occ))
        obs_roofline.note_dispatch(
            "ivf_flat.search",
            {"q": q, "dim": index.dim, "n_lists": index.n_lists,
             "max_list_size": index.max_list_size,
             "n_probes": int(n_probes), "k": int(k),
             "dtype": dtype_name(index.list_data.dtype)},
            occupancy=occ)
    faultpoint("ivf_flat.search.scan")
    with obs.record_span("ivf_flat::scan", attrs=scan_attrs), \
            obs_compile.watch():
        if backend == "gather":
            return _search_gather(index, queries, int(k), n_probes,
                                  select_algo, res, filter)
        return _search_ragged(index, queries, int(k), n_probes, select_algo,
                              res, filter)


# ---------------------------------------------------------------------------
# Paged search (serving): scan a PagedListStore's vector pages through K3
# ---------------------------------------------------------------------------


def _paged_row_bytes(store) -> int:
    """Bytes of one scanned pool row: the int8 decoded cache for IVF-PQ,
    the payload page otherwise."""
    payload = store.page_cache if store.kind == "ivf_pq" else store.pages
    return int(payload.shape[-1]) * payload.element_size()


def paged_block_error(store, k: int) -> Optional[str]:
    """Why the paged plan of this store cannot feed k to K3 / K4 (pages
    under 8 rows, k over 512, or a fetch block narrower than k), or None
    when it can."""
    width, rows = store.table_width, store.page_rows
    if ss.paged_eligible(width, rows, _paged_row_bytes(store), int(k)):
        return None
    _, _, w = ss.paged_plan(width, rows, _paged_row_bytes(store), int(k))
    return (f"the paged scan cannot serve k={k} on this store (page_rows "
            f"{rows}, table_width {width}, fetch block {w} rows): it needs "
            "page_rows >= 8, k <= 512 and k <= the fetch block")


def paged_backend_auto(store, k: int) -> str:
    """The engine ``backend="auto"`` takes: ``"paged"`` (kernel K3, K4 for
    IVF-BQ, on a CUDA store; their plain twins on a CPU store) wherever the
    store's plan can feed k, else ``"gather"`` for flat and PQ stores. An
    IVF-BQ store the plan cannot feed raises ``ValueError`` naming why."""
    why = paged_block_error(store, k)
    if why is None:
        return "paged"
    if store.kind == "ivf_bq":
        raise ValueError(f"{why}; IVF-BQ serves only through K4")
    return "gather"


def check_paged_eligible(store, k: int) -> None:
    """Raise ``ValueError`` with the reason when an explicit
    ``backend="paged"`` cannot serve k on this store."""
    why = paged_block_error(store, k)
    if why is not None:
        if store.kind != "ivf_bq":
            why += "; backend='auto' serves it through the gather scan"
        raise ValueError(why)


def _paged_plan_static(store, n_probes: int, k: int, res, dim: int) -> int:
    """Query tile of a paged search: ``_ragged_plan_static``'s rule over
    the capacity layout (one length class, ``class_counts = (n_lists,)``)."""
    return ss.fit_q_tile(1 << 30, n_probes, store.n_lists, 1, int(k),
                         res.workspace_bytes, dim=dim,
                         class_counts=(store.n_lists,))


def _paged_fused(queries, centers, pages, bias_pool, page_ids, table,
                 chain_pages, k: int, n_probes: int, metric: str,
                 select_algo: str, res: Resources, q_tile: int):
    """Coarse gemm, device strip plan over the capacity layout, K3 over the
    page pool in place, merge and finalize. The bias pool is already +inf
    at dead slots."""
    obs_compile.trace_event(
        "ivf_flat.paged_pallas", queries=queries, centers=centers,
        pages=pages, bias_pool=bias_pool, page_ids=page_ids, table=table,
        chain_pages=chain_pages,
        static={"k": k, "n_probes": n_probes, "metric": metric,
                "select_algo": select_algo,
                "compute_dtype": res.compute_dtype, "q_tile": q_tile})
    probes = _coarse_probes(queries, centers, n_probes, metric, select_algo,
                            res.compute_dtype)
    l2 = metric in ("sqeuclidean", "euclidean")
    vals, ids = ss.paged_strip_search_traced(
        queries, probes, pages, bias_pool, page_ids, table, chain_pages,
        int(k), int(k), -2.0 if l2 else -1.0, q_tile)
    return _finalize_ragged(vals, ids, queries, metric)


def _paged_search_args(store, kind: str, queries, k: int, n_probes: int,
                       filter, backend: str, res, device, k_cap=None,
                       backends=PAGED_BACKENDS):
    """What every family's ``search_paged`` settles first → (resources,
    n_probes, queries, filter, backend, filter span attributes). A call
    without ``filter`` takes the store's standing one
    (:meth:`PagedListStore.set_filter`); either widens n_probes, past the
    ``<kind>.search.filter`` faultpoint. ``k_cap`` bounds k further (IVF-BQ: 512);
    ``backends`` are the kind's names, ``"auto"`` resolving by
    :func:`paged_backend_auto`."""
    if store.kind != kind:
        raise ValueError(f"expected an {kind} store, got {store.kind!r}")
    if backend not in backends:
        raise ValueError(f"unknown backend {backend!r} (expected one of "
                         f"{backends})")
    res = resources_for(device, res)
    if store.device != res.device:
        raise ValueError(f"store lives on {store.device}, search runs on "
                         f"{res.device}")
    if filter is None:
        filter = store.filter
    n_probes = int(min(n_probes, store.n_lists))
    n_probes, filter_attrs = _filter_plan(f"{kind}.search.filter", filter,
                                          n_probes, store.n_lists)
    limit = n_probes * store.table_width * store.page_rows
    if k_cap is not None:
        limit = min(limit, k_cap)
    if not 0 < k <= limit:
        raise ValueError(f"k={k} out of range")
    if backend == "auto":
        backend = paged_backend_auto(store, k)
    elif backend == "paged":
        check_paged_eligible(store, k)
    queries = _prep_queries(queries, store.dim, store.metric, res.device)
    return res, n_probes, queries, filter, backend, filter_attrs


@contextlib.contextmanager
def _paged_scan_span(store, backend: str, q: int, n_probes: int, k: int,
                     filter_attrs: Optional[dict], res):
    """The scan span of a paged search (``<kind>::paged_pallas`` for the
    K3/K4 engine or its named twin, ``<kind>::paged_scan`` for the
    gather), past the
    ``<kind>.search_paged.scan`` faultpoint, with the
    ``<kind>.search_paged.*`` counters when telemetry is on."""
    kind = store.kind
    attrs = None
    if obs.enabled():
        attrs = _scan_telemetry(f"{kind}.search_paged", backend, q, n_probes,
                                k, filter_attrs,
                                table_width=int(store.table_width))
        _note_paged(store, backend, q, n_probes, k, res)
    faultpoint(f"{kind}.search_paged.scan")
    name = "paged_scan" if backend == "gather" else "paged_pallas"
    # the ledger watch stamps a new signature's record with the dispatch's
    # wall clock
    with obs.record_span(f"{kind}::{name}", attrs=attrs) as span, \
            obs_compile.watch():
        yield span


def _note_paged(store, backend: str, q: int, n_probes: int, k: int,
                res) -> None:
    """The roofline note of one paged search: the gather scan's
    capacity-padded per-(query, probe) model, or K3/K4's strip-shared one
    with the paged planner's occupancy (memoized on the store until its
    layout or fill moves). Called only under ``obs.enabled()``."""
    kind = store.kind
    width = int(store.table_width)
    base = {"q": q, "dim": store.dim, "n_lists": store.n_lists,
            "page_rows": store.page_rows, "table_width": width,
            "n_probes": int(n_probes), "k": int(k)}
    if kind == "ivf_pq":
        rot_dim = int(store.rotation.shape[0])
        pq = dict(base, pq_dim=store.pq_dim, pq_bits=store.pq_bits,
                  rot_dim=rot_dim)
        if backend == "gather":
            obs_roofline.note_dispatch("ivf_pq.paged_scan", pq)
            return
        row_bytes, dim, entry, model = rot_dim, rot_dim, \
            "ivf_pq.paged_pallas", pq
    elif kind == "ivf_bq":
        rot_dim = int(store.rotation.shape[0])
        row_bytes = int(store.pages.shape[-1])
        dim = rot_dim * store.bq_bits
        entry, model = "ivf_bq.paged_pallas", dict(
            base, rot_dim=rot_dim, bits=store.bq_bits,
            rotation_kind=store.rotation_kind)
    else:
        flat = dict(base, dtype=dtype_name(store.pages.dtype))
        if backend == "gather":
            obs_roofline.note_dispatch("ivf_flat.paged_scan", flat)
            return
        row_bytes = int(store.pages.shape[-1]) * store.pages.element_size()
        dim, entry, model = store.dim, "ivf_flat.paged_pallas", flat
    with store._lock:
        chain = store._list_pages.copy()
        key = (store.pages_used, len(store._id_loc), store._tombstones,
               width, q, int(n_probes), int(k), res.workspace_bytes)
        live, dead = len(store._id_loc), store._tombstones
    occ = obs_roofline.memo_occupancy(
        store, key,
        lambda: ss.paged_occupancy_stats(
            width, store.page_rows, chain, live, dead, q, int(n_probes),
            int(k), row_bytes, workspace_bytes=res.workspace_bytes,
            dim=dim))
    obs_roofline.note_dispatch(entry, model, occupancy=occ)


def _page_gather(table, page_ids, payload, aux):
    """``gather(probes)`` over a page table: each probed list's chain
    slots (absent slots read page 0) → (payload (qt, p, W·R, ·), ids (qt,
    p, W·R) with -1 at absent slots, aux (qt, p, W·R) or None)."""
    page_rows = page_ids.shape[1]

    def gather(pb):
        tbl = table[pb]                                   # (qt, p, W)
        safe = tbl.clamp(min=0).to(torch.int64)
        qt, p, width = tbl.shape
        cols = width * page_rows
        ids = torch.where(tbl[..., None] >= 0, page_ids[safe], -1)
        return (payload[safe].reshape((qt, p, cols) + tuple(payload.shape[2:])),
                ids.reshape(qt, p, cols),
                None if aux is None else aux[safe].reshape(qt, p, cols))
    return gather


@traced("ivf_flat::search_paged")
def search_paged(store, queries, k: int, n_probes: int = 20, filter=None,
                 select_algo: str = "exact", backend: str = "auto",
                 res: Optional[Resources] = None,
                 device: Optional[DeviceLike] = None):
    """k-NN over a mutable paged vector store (``PagedListStore`` of kind
    ``"ivf_flat"``): :func:`search`'s contract, while rows stream in and
    out. ``backend``: "paged" (K3 over the store's pools, in place),
    "gather" (the gather scan over the page table, plain torch, any k) or
    "auto" (:func:`paged_backend_auto`). ``filter`` (else the store's
    standing one) masks source ids: an +inf bias lane for K3, a validity
    mask for the gather."""
    res, n_probes, queries, filter, backend, filter_attrs = \
        _paged_search_args(store, "ivf_flat", queries, k, n_probes, filter,
                           backend, res, device)
    with _paged_scan_span(store, backend, int(queries.shape[0]), n_probes, k,
                          filter_attrs, res):
        if backend == "gather":
            pages, page_ids, page_aux, table = store.scan_state()
            l2 = store.metric in ("sqeuclidean", "euclidean")
            obs_compile.trace_event(
                "ivf_flat.paged_scan", queries=queries, centers=store.centers,
                pages=pages, page_ids=page_ids, page_aux=page_aux,
                table=table, filter=filter,
                static={"k": int(k), "n_probes": n_probes,
                        "metric": store.metric, "select_algo": select_algo,
                        "compute_dtype": res.compute_dtype})
            return _gather_scan(
                queries, store.centers, store.metric, int(k), n_probes,
                select_algo, res, table.shape[1] * store.page_rows,
                _page_gather(table, page_ids, pages,
                             page_aux if l2 else None), filter)
        pages, bias_pool, _, page_ids, table, chain_pages = \
            store.paged_scan_state()
        bias_pool = _filtering.apply_filter_bias(bias_pool, page_ids, filter)
        q_tile = min(_paged_plan_static(store, n_probes, k, res, store.dim),
                     queries.shape[0])
        return _paged_fused(queries, store.centers, pages, bias_pool,
                            page_ids, table, chain_pages, int(k), n_probes,
                            store.metric, select_algo, res, q_tile)
