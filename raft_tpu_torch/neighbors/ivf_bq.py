"""IVF-BQ: inverted lists of RaBitQ-style 1-bit (or 2–4-bit) codes
(counterpart of ``raft_tpu/neighbors/ivf_bq.py``).

Estimator. For list l with center c_l, a row's residual r = x − c_l is
rotated, u = R·r̃ (R orthogonal, so ‖u‖ = ‖r‖), and stored as its code
levels L (signs for bits = 1) plus two per-row scalars:
``f = ‖u‖²/⟨L, u⟩`` (the unbiasing factor, ``list_scale``) and, for L2,
``‖c_l‖² + ‖u‖² + 2·f·⟨L, R·c̃_l⟩`` (``list_bias``, +inf at padding). Then

    d̂²(q, x) = ‖q‖² − 2⟨q, c_l⟩ − 2·f·⟨L, R·q̃⟩ + bias

so a search is one coarse gemm (which also gives the exact −2⟨q, c_l⟩
pair term) plus one ±1 contraction per probed strip, kernel K2
(:mod:`raft_tpu_torch.ops.bq_scan`). The estimate ranks candidates; the
recall-gated configuration over-fetches and re-ranks exactly
(:func:`search_refined`, :mod:`raft_tpu_torch.neighbors.refine`).

Lists use the fixed 512-row granule with power-of-two chunks, so every
index is strip-eligible. Random numbers come from ``torch.Generator``s
seeded from ``params.seed``: a port-built index is not the JAX package's
bit for bit (``from_jax_arrays`` carries one across).

This port has build, search and search_refined for all four metrics,
bits 1–4 and both rotation kinds, and the paged search over a
``PagedListStore`` (kernel K4, :func:`search_paged`). Filtered search,
``extend``, the streamed build and ``reconstruct_rows`` come with later
slices and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.core.serialize import load_arrays, save_arrays
from raft_tpu_torch.neighbors import _packing, refine
from raft_tpu_torch.neighbors.ivf_flat import (_finalize_ragged,
                                               _paged_plan_static,
                                               _paged_search_args,
                                               _ragged_plan_static)
from raft_tpu_torch.neighbors.ivf_pq import _pq_probe_prep
from raft_tpu_torch.ops import bq_scan, linalg
from raft_tpu_torch.ops.distance import canonical_metric, sqnorm

SUPPORTED_METRICS = ("sqeuclidean", "euclidean", "inner_product", "cosine")
_LATER = "arrives with a later slice of the PyTorch port"

#: fixed list granule: code rows are tiny, so the strip alignment is
#: near-free and every index is strip-eligible
_GROUP = 512


@dataclass(frozen=True)
class IvfBqParams:
    """Build params. ``rotation_kind``: "dense" (QR rotation matrix) or
    "hadamard" (SRHT sign diagonal, O(d·log d) apply). ``bits`` (1–4):
    bits per rotated dimension."""

    n_lists: int = 1024
    metric: str = "sqeuclidean"
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    list_size_cap: int = -1         # -1 auto (4× mean), 0 off
    bits: int = 1
    rotation_kind: str = "dense"
    seed: int = 0

    def __post_init__(self):
        m = canonical_metric(self.metric)
        if m not in SUPPORTED_METRICS:
            raise ValueError(f"ivf_bq supports {SUPPORTED_METRICS}, got {self.metric!r}")
        object.__setattr__(self, "metric", m)
        if not 1 <= self.bits <= 4:
            raise ValueError(f"bits must be in [1, 4], got {self.bits}")
        if self.rotation_kind not in linalg.ROTATION_KINDS:
            raise ValueError(
                f"rotation_kind must be one of {linalg.ROTATION_KINDS}, "
                f"got {self.rotation_kind!r}")


@dataclass
class IvfBqIndex:
    """Coarse centers, rotation, packed codes and correction scalars;
    ``list_ids == -1`` marks padding (scale 0, bias +inf there)."""

    centers: torch.Tensor      # (n_lists, dim) fp32, unrotated
    rotation: torch.Tensor     # (rot_dim, rot_dim) dense | (rot_dim,) signs
    list_codes: torch.Tensor   # (n_lists, m, bits·rot_dim/8) uint8
    list_ids: torch.Tensor     # (n_lists, m) int32
    list_scale: torch.Tensor   # (n_lists, m) fp32
    list_bias: torch.Tensor    # (n_lists, m) fp32
    metric: str = "sqeuclidean"
    bits: int = 1
    rotation_kind: str = "dense"
    _lens_np_cache: Optional[np.ndarray] = field(default=None, repr=False)
    _ragged_static_cache: Any = field(default=None, repr=False)

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def rot_dim(self) -> int:
        return self.rotation.shape[0]

    @property
    def max_list_size(self) -> int:
        return self.list_codes.shape[1]

    @property
    def code_bytes_per_row(self) -> int:
        return int(self.list_codes.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.centers.device

    @property
    def size(self) -> int:
        return int((self.list_ids >= 0).sum())

    def list_sizes(self) -> torch.Tensor:
        return (self.list_ids >= 0).sum(dim=1).to(torch.int32)

    def to(self, device: DeviceLike) -> "IvfBqIndex":
        """A copy of the index with its tensors on ``device``."""
        dev = torch.device(device)
        return IvfBqIndex(*(t.to(dev) for t in self.arrays().values()),
                          self.metric, self.bits, self.rotation_kind)

    def arrays(self) -> Dict[str, torch.Tensor]:
        return {"centers": self.centers, "rotation": self.rotation,
                "list_codes": self.list_codes, "list_ids": self.list_ids,
                "list_scale": self.list_scale, "list_bias": self.list_bias}

    def meta(self) -> Dict[str, Any]:
        return {"kind": "ivf_bq", "metric": self.metric, "bits": self.bits,
                "rotation_kind": self.rotation_kind}

    def save(self, path) -> None:
        """Write the v2 container both packages read."""
        save_arrays(path, self.meta(), self.arrays())

    @classmethod
    def load(cls, path, device: Optional[DeviceLike] = None,
             res: Optional[Resources] = None) -> "IvfBqIndex":
        """Read an ``ivf_bq`` container written by either package."""
        meta, arrays = load_arrays(path)
        return from_jax_arrays(meta, arrays, device=device, res=res)


def from_jax_arrays(meta: Mapping[str, Any], arrays: Mapping[str, Any],
                    device: Optional[DeviceLike] = None,
                    res: Optional[Resources] = None) -> IvfBqIndex:
    """An index from the JAX package's arrays (``centers``, ``rotation``,
    ``list_codes``, ``list_ids``, ``list_scale``, ``list_bias`` as numpy or
    anything ``np.asarray`` takes) and its container meta. Files without
    ``bits`` / ``rotation_kind`` are 1-bit dense-rotation indexes."""
    if meta.get("kind", "ivf_bq") != "ivf_bq":
        raise ValueError(f"not an ivf_bq index: {meta.get('kind')}")
    rkind = meta.get("rotation_kind", "dense")
    if rkind not in linalg.ROTATION_KINDS:
        raise ValueError(
            f"unknown ivf_bq rotation_kind {rkind!r} (supported: "
            f"{linalg.ROTATION_KINDS}); the file may come from a newer "
            "format revision")
    dev = resources_for(device, res).device

    def t(name):
        return torch.from_numpy(np.array(arrays[name])).to(dev)

    return IvfBqIndex(
        t("centers"), t("rotation"), t("list_codes"), t("list_ids"),
        t("list_scale"), t("list_bias"), meta.get("metric", "sqeuclidean"),
        int(meta.get("bits", 1)), rkind)


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------


def auto_rot_dim(dim: int, rotation_kind: str = "dense") -> int:
    """Rotation width: dim rounded up to whole code bytes (dense), or to
    the next power of two (hadamard)."""
    if rotation_kind == "hadamard":
        return linalg.hadamard_rot_dim(dim)
    return -(-dim // 8) * 8


def _make_rotation(generator: torch.Generator, rot_dim: int,
                   rotation_kind: str, device: torch.device) -> torch.Tensor:
    """The rotation operand of either kind (dense QR matrix or SRHT sign
    diagonal) from one generator."""
    if rotation_kind == "hadamard":
        return linalg.make_srht_signs(generator, rot_dim, device)
    return linalg.make_rotation_matrix(generator, rot_dim, device)


def _encode_math(rows, labels, centers, rotation, rc, c2, l2: bool,
                 bits: int = 1, rotation_kind: str = "dense"):
    """Encode one row chunk: rotate the residual, quantize to ``bits``-bit
    levels, bake the two correction scalars → (packed codes (m, bits·nb)
    uint8, scale (m,) fp32, bias (m,) fp32). ``rc`` is the rotated
    centers, ``c2`` their squared norms."""
    labels = labels.to(torch.int64)
    u = linalg.rotate_rows(rows - centers[labels], rotation, rotation_kind)
    norm2 = (u * u).sum(dim=1)
    if bits == 1:
        signs = torch.where(u >= 0, 1, -1).to(torch.int8)
        packed = bq_scan.pack_sign_bits(signs)
        # ⟨b, u⟩ = ‖u‖₁ for the sign code
        proj = u.abs().sum(dim=1)
        levels_f = signs.to(torch.float32)
    else:
        # symmetric uniform quantizer over [−t, t], t = max|u| per row:
        # code c ∈ [0, 2^bits), level L = 2c − (2^bits − 1)
        t = torch.clamp(u.abs().amax(dim=1, keepdim=True), min=1e-30)
        c = torch.clamp(torch.floor((u / t + 1.0) * (0.5 * (1 << bits))),
                        0, (1 << bits) - 1).to(torch.uint8)
        packed = bq_scan.pack_code_planes(c, bits)
        levels_f = 2.0 * c.to(torch.float32) - float((1 << bits) - 1)
        proj = (levels_f * u).sum(dim=1)
    # f = ‖u‖²/⟨L, u⟩; a zero residual gets f = 0 (an exact estimate)
    scale = norm2 / torch.clamp(proj, min=1e-30)
    if l2:
        g = (levels_f * rc[labels]).sum(dim=1)
        bias = c2[labels] + norm2 + 2.0 * scale * g
    else:
        bias = torch.zeros_like(scale)
    return packed, scale, bias


def _encode_chunk(rows, labels, centers, rotation, rc, c2, l2: bool,
                  bits: int = 1, rotation_kind: str = "dense"):
    """One chunk of rows encoded as the packed build encodes them (the
    paged store's upsert path): :func:`_encode_math`."""
    return _encode_math(rows, labels, centers, rotation, rc, c2, l2, bits,
                        rotation_kind)


def _encode_rows(work, labels, centers, rotation, metric: str, bits: int = 1,
                 rotation_kind: str = "dense", chunk: int = 262_144):
    """:func:`_encode_math` over all rows in chunks, so no (n, rot_dim)
    fp32 residual block is held at once."""
    l2 = metric in ("sqeuclidean", "euclidean")
    rc = linalg.rotate_rows(centers, rotation, rotation_kind)
    c2 = sqnorm(centers)
    parts = [_encode_math(work[s:s + chunk], labels[s:s + chunk], centers,
                          rotation, rc, c2, l2, bits, rotation_kind)
             for s in range(0, work.shape[0], chunk)]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat([p[i] for p in parts]) for i in range(3))


def build(dataset, params: IvfBqParams = IvfBqParams(),
          res: Optional[Resources] = None,
          device: Optional[DeviceLike] = None) -> IvfBqIndex:
    """Train the coarse centers (balanced k-means), draw the rotation,
    encode every row and pack the lists. Beyond k-means the build is one
    rotation and a few reductions per row: there is no codebook."""
    res = resources_for(device, res)
    dev = res.device
    work = torch.as_tensor(dataset).to(device=dev, dtype=torch.float32)
    n, dim = work.shape
    if params.n_lists > n:
        raise ValueError(f"n_lists={params.n_lists} > n_rows={n}")
    rot_dim = auto_rot_dim(dim, params.rotation_kind)
    if params.metric == "cosine":
        work = work / torch.clamp(torch.linalg.vector_norm(work, dim=1,
                                                           keepdim=True),
                                  min=1e-30)
    km_metric = ("inner_product" if params.metric in ("cosine", "inner_product")
                 else "sqeuclidean")
    km = kmeans_balanced.KMeansBalancedParams(
        n_iters=params.kmeans_n_iters, metric=km_metric, seed=params.seed)
    g_train, g_rot = kmeans_balanced.seeded_generators(params.seed, 2, dev)
    n_train = max(params.n_lists, int(n * params.kmeans_trainset_fraction))
    if n_train < n:
        rows = torch.randint(0, n, (n_train,), generator=g_train, device=dev)
        centers = kmeans_balanced.fit(work[rows], params.n_lists, km, res=res)
        labels = kmeans_balanced.predict(work, centers, km, res=res)
    else:
        centers, labels = kmeans_balanced.fit_predict(work, params.n_lists, km,
                                                      res=res)
    cap = params.list_size_cap
    if cap < 0:
        cap = _packing.auto_list_cap(n, params.n_lists, _GROUP)
    if cap:
        labels = _packing.spill_to_cap(work, centers, labels, km_metric, cap)

    rotation = _make_rotation(g_rot, rot_dim, params.rotation_kind, dev)
    codes, scale, bias = _encode_rows(work, labels, centers, rotation,
                                      params.metric, params.bits,
                                      params.rotation_kind)
    row_ids = torch.arange(n, dtype=torch.int32, device=dev)
    list_codes, list_ids = _packing.pack_lists(
        codes, row_ids, labels, params.n_lists, _GROUP, pow2_chunks=True)
    aux, _ = _packing.pack_lists(torch.stack([scale, bias], dim=1), row_ids,
                                 labels, params.n_lists, _GROUP,
                                 pow2_chunks=True)
    list_bias = torch.where(list_ids >= 0, aux[:, :, 1], float("inf"))
    return IvfBqIndex(centers, rotation, list_codes, list_ids,
                      aux[:, :, 0].contiguous(), list_bias.contiguous(),
                      params.metric, params.bits, params.rotation_kind)


def extend(index, new_vectors, new_ids=None, res=None, device=None):
    raise NotImplementedError(f"ivf_bq.extend {_LATER}")


def build_streaming(chunk_fn, n, dim, params=IvfBqParams(), res=None,
                    device=None, chunk_rows=0, train_rows=0):
    raise NotImplementedError(f"ivf_bq.build_streaming {_LATER}")


def reconstruct_rows(centers, rotation, codes, scale, labels, bits=1,
                     rotation_kind="dense", dim=None):
    raise NotImplementedError(f"ivf_bq.reconstruct_rows {_LATER}")


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


def _bq_search_prep(queries, centers, rotation, n_probes: int,
                    select_algo: str, l2: bool, bits: int = 1,
                    rotation_kind: str = "dense"):
    """Stage 1 and the scan's query operand: ivf_pq's shared probe prep
    (one coarse gemm for the probes and the exact pair term), then the
    rotated query extended to the code's bit-planes."""
    probes, qr, pair_const = _pq_probe_prep(
        queries, centers, rotation, n_probes, select_algo, l2, rotation_kind)
    return probes, bq_scan.extend_query_planes(qr, bits), pair_const


def _bq_fused(queries, index: IvfBqIndex, k: int, n_probes: int,
              select_algo: str, l2: bool, classes, class_counts, cls_ord,
              q_tile: int):
    """Prep, device plan, packed strip scan (tournament allowed: the path
    over-fetches and re-ranks exactly) and finalize (‖Rq̃‖² = ‖q‖²)."""
    probes, qr, pair_const = _bq_search_prep(
        queries, index.centers, index.rotation, n_probes, select_algo, l2,
        index.bits, index.rotation_kind)
    vals, ids = bq_scan.bq_strip_search_traced(
        qr, probes, index.list_codes, index.list_scale, index.list_bias,
        index.list_ids, cls_ord, classes, class_counts, int(k), int(k),
        -2.0 if l2 else -1.0, q_tile, pair_const=pair_const, approx_ok=True)
    return _finalize_ragged(vals, ids, queries, index.metric)


def search(index: IvfBqIndex, queries, k: int, n_probes: int = 20,
           filter=None, select_algo: str = "exact",
           res: Optional[Resources] = None,
           device: Optional[DeviceLike] = None):
    """Approximate k-NN over the packed lists → (distances (q, k) fp32, ids
    (q, k) int32). Distances are unbiased estimates, not exact: re-rank
    with :func:`search_refined` for the recall-gated configuration."""
    if filter is not None:
        raise NotImplementedError(f"filtered ivf_bq search {_LATER}")
    res = resources_for(device, res)
    if index.device != res.device:
        raise ValueError(f"index lives on {index.device}, search runs on "
                         f"{res.device}; move it with index.to(device)")
    queries = torch.as_tensor(queries).to(device=res.device, dtype=torch.float32)
    if queries.ndim != 2 or queries.shape[1] != index.dim:
        raise ValueError(f"queries must be (q, {index.dim}), got {tuple(queries.shape)}")
    n_probes = int(min(n_probes, index.n_lists))
    if not 0 < k <= min(n_probes * index.max_list_size, 512):
        raise ValueError(
            f"k={k} out of range (1..min(n_probes·max_list_size, 512)) for "
            f"n_probes={n_probes} x max_list_size={index.max_list_size}")
    if index.metric == "cosine":
        queries = queries / torch.clamp(
            torch.linalg.vector_norm(queries, dim=1, keepdim=True), min=1e-30)
    l2 = index.metric in ("sqeuclidean", "euclidean")
    # plan at the scan's real row width: bits·rot_dim unpacked columns
    classes, class_counts, cls_ord, q_tile = _ragged_plan_static(
        index, n_probes, k, res, index.rot_dim * index.bits)
    return _bq_fused(queries, index, int(k), n_probes, select_algo, l2,
                     classes, class_counts, cls_ord,
                     min(q_tile, queries.shape[0]))


def search_refined(index: IvfBqIndex, dataset, queries, k: int,
                   n_probes: int = 20, refine_ratio: int = 4, filter=None,
                   res: Optional[Resources] = None,
                   device: Optional[DeviceLike] = None):
    """The recall-gated configuration: over-fetch ``k·refine_ratio``
    estimated candidates (at most 512), then re-rank them exactly against
    ``dataset``, the caller's original rows."""
    if refine_ratio < 1:
        raise ValueError(f"refine_ratio must be >= 1, got {refine_ratio}")
    res = resources_for(device, res)
    k_fetch = min(int(k) * int(refine_ratio), 512)
    _, cand = search(index, queries, k_fetch, n_probes=n_probes,
                     filter=filter, res=res)
    return refine.refine(dataset, queries, cand, int(k), metric=index.metric,
                         res=res)


# ---------------------------------------------------------------------------
# Paged search (serving): K4 over a PagedListStore's code pools
# ---------------------------------------------------------------------------


def _paged_fused_bq(queries, store, codes_pool, scale_pool, bias_pool,
                    page_ids, table, chain_pages, k: int, n_probes: int,
                    select_algo: str, q_tile: int):
    """The packed path's prep (probes, plane-extended rotated queries, the
    exact pair term), K4 over the store's code, scale and bias pools in
    place, merge and finalize. No tournament: the paged scan runs the
    exact carry."""
    l2 = store.metric in ("sqeuclidean", "euclidean")
    probes, qr, pair_const = _bq_search_prep(
        queries, store.centers, store.rotation, n_probes, select_algo, l2,
        store.bq_bits, store.rotation_kind)
    vals, ids = bq_scan.paged_bq_search_traced(
        qr, probes, codes_pool, scale_pool, bias_pool, page_ids, table,
        chain_pages, int(k), int(k), -2.0 if l2 else -1.0, q_tile,
        pair_const=pair_const)
    return _finalize_ragged(vals, ids, queries, store.metric)


def search_paged(store, queries, k: int, n_probes: int = 20, filter=None,
                 select_algo: str = "exact", backend: str = "auto",
                 res: Optional[Resources] = None,
                 device: Optional[DeviceLike] = None):
    """Approximate k-NN over a mutable paged code store (``PagedListStore``
    of kind ``"ivf_bq"``): :func:`search`'s estimator contract while rows
    stream in and out, k ≤ min(n_probes·table_width·page_rows, 512).
    ``backend``: "paged" (K4 over the store's pools) or "auto" (the
    same). Re-rank with :func:`raft_tpu_torch.neighbors.refine.refine`."""
    res, n_probes, queries = _paged_search_args(
        store, "ivf_bq", queries, k, n_probes, filter, backend, res, device,
        k_cap=512)
    codes_pool, bias_pool, scale_pool, page_ids, table, chain_pages = \
        store.paged_scan_state()
    rot_dim = int(store.rotation.shape[0])
    q_tile = min(_paged_plan_static(store, n_probes, k, res,
                                    rot_dim * store.bq_bits),
                 queries.shape[0])
    return _paged_fused_bq(queries, store, codes_pool, scale_pool, bias_pool,
                           page_ids, table, chain_pages, int(k), n_probes,
                           select_algo, q_tile)
