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

This port has build, the streamed :func:`build_streaming`, :func:`extend`,
search and search_refined for all four metrics, bits 1–4 and both rotation
kinds, :func:`reconstruct_rows`, and the paged search over a
``PagedListStore`` (kernel K4, :func:`search_paged`). ``filter`` is one
more bias operand of K2 and K4 (+inf where a source id fails).

Telemetry, fault injection and recovery are the JAX package's:
``ivf_bq::build`` (phases ``coarse_train``, ``encode``, ``pack``),
``ivf_bq::build_streaming`` (``coarse_train``, one ``encode_chunk`` span a
chunk), ``ivf_bq::search`` → ``ivf_bq::scan``, ``ivf_bq::search_paged`` →
``ivf_bq::paged_pallas``; ``ivf_bq.build.*`` and ``ivf_bq.search*``
counters; the ``ivf_bq.build.encode_chunk``, ``ivf_bq.search.filter``,
``.search.scan`` and ``.search_paged.scan`` faultpoints. Two of them
recover from an OOM by re-running the same path smaller
(``resilience.degrade_on_oom``): the streamed encode halves its sub-chunk
(``ivf_bq.build.degraded_chunk``; rows are encoded independently, so the
index is bit-identical) and the search halves its query tile
(``ivf_bq.search.degraded_tile``).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.obs import compile as obs_compile
from raft_tpu_torch.obs import roofline as obs_roofline
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.core.interruptible import check_interrupt
from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.core.serialize import load_arrays, save_arrays
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.neighbors import _filtering, _packing, refine
from raft_tpu_torch.neighbors.ivf_flat import (_filter_plan,
                                               _finalize_ragged,
                                               _paged_plan_static,
                                               _paged_scan_span,
                                               _paged_search_args,
                                               _ragged_plan_static,
                                               _scan_telemetry)
from raft_tpu_torch.neighbors.ivf_pq import (_chunk_positions,
                                             _pq_probe_prep, _sync)
from raft_tpu_torch.ops import bq_scan, linalg
from raft_tpu_torch.ops.distance import canonical_metric, sqnorm
from raft_tpu_torch.resilience import (degrade_on_oom, faultpoint,
                                       record_event)

SUPPORTED_METRICS = ("sqeuclidean", "euclidean", "inner_product", "cosine")
PAGED_BACKENDS = ("auto", "paged", "paged_jnp")

#: compile-ledger entry of the packed scan: a record-count delta of zero
#: across repeated searches is the steady state (obs/compile.py)
_LEDGER_ENTRY = "ivf_bq.search"


def scan_trace_count() -> int:
    """New signatures the packed BQ scan has met in this process — a shim
    over the compile ledger, deltaed like the JAX package's."""
    return obs_compile.trace_count(_LEDGER_ENTRY)
_log = logging.getLogger("raft_tpu_torch")

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
    #: streamed builds: seconds of training, pass 1 and pass 2
    build_timings_s: Optional[Dict[str, float]] = None
    #: streamed builds: rows whose two nearest capped lists were full
    _streaming_dropped: int = 0
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


@traced("ivf_bq::build")
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
    with obs.record_span("ivf_bq::coarse_train"):
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
        obs.add("ivf_bq.build.rows", n)
        obs.add("ivf_bq.build.lists", params.n_lists)
    cap = params.list_size_cap
    if cap < 0:
        cap = _packing.auto_list_cap(n, params.n_lists, _GROUP)
    if cap:
        labels = _packing.spill_to_cap(work, centers, labels, km_metric, cap)

    rotation = _make_rotation(g_rot, rot_dim, params.rotation_kind, dev)
    enc_attrs = ({"rows": int(n), "bits": int(params.bits),
                  "rotation_kind": params.rotation_kind}
                 if obs.enabled() else None)
    with obs.record_span("ivf_bq::encode", attrs=enc_attrs):
        codes, scale, bias = _encode_rows(work, labels, centers, rotation,
                                          params.metric, params.bits,
                                          params.rotation_kind)
    with obs.record_span("ivf_bq::pack"):
        row_ids = torch.arange(n, dtype=torch.int32, device=dev)
        list_codes, list_ids = _packing.pack_lists(
            codes, row_ids, labels, params.n_lists, _GROUP, pow2_chunks=True)
        aux, _ = _packing.pack_lists(torch.stack([scale, bias], dim=1),
                                     row_ids, labels, params.n_lists, _GROUP,
                                     pow2_chunks=True)
    list_bias = torch.where(list_ids >= 0, aux[:, :, 1], float("inf"))
    return IvfBqIndex(centers, rotation, list_codes, list_ids,
                      aux[:, :, 0].contiguous(), list_bias.contiguous(),
                      params.metric, params.bits, params.rotation_kind)


@traced("ivf_bq::extend")
def extend(index: IvfBqIndex, new_vectors, new_ids=None,
           res: Optional[Resources] = None,
           device: Optional[DeviceLike] = None) -> IvfBqIndex:
    """Encode new rows with the index's quantizers and repack → a new
    index. The old rows' codes and scalars are carried as they are (codes
    cannot give the vectors back); new rows go to their nearest fixed
    center and spill under the auto cap on top of each list's fill. Ids
    default to ``max + 1 …``."""
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
    km_metric = ("inner_product" if index.metric in ("cosine", "inner_product")
                 else "sqeuclidean")
    labels = kmeans_balanced.predict(
        X, index.centers, kmeans_balanced.KMeansBalancedParams(
            metric=km_metric), res=res)
    cap = _packing.auto_list_cap(index.size + X.shape[0], index.n_lists,
                                 _GROUP)
    labels = _packing.spill_to_cap(X, index.centers, labels, km_metric, cap,
                                   base_counts=index.list_sizes())
    new_codes, new_scale, new_bias = _encode_rows(
        X, labels, index.centers, index.rotation, index.metric, index.bits,
        index.rotation_kind)
    old_codes, old_ids, old_labels = _packing.unpack_lists(index.list_codes,
                                                           index.list_ids)
    old_aux, _, _ = _packing.unpack_lists(
        torch.stack([index.list_scale,
                     torch.where(index.list_ids >= 0, index.list_bias, 0.0)],
                    dim=2), index.list_ids)
    if new_ids is None:
        start = int(old_ids.max()) + 1 if old_ids.numel() else 0
        new_ids = torch.arange(start, start + X.shape[0], dtype=torch.int32,
                               device=X.device)
    else:
        new_ids = torch.as_tensor(new_ids).to(X.device, torch.int32)
    all_ids = torch.cat([old_ids, new_ids])
    all_labels = torch.cat([old_labels.to(torch.int64), labels.to(torch.int64)])
    list_codes, list_ids = _packing.pack_lists(
        torch.cat([old_codes, new_codes]), all_ids, all_labels,
        index.n_lists, _GROUP, pow2_chunks=True)
    aux, _ = _packing.pack_lists(
        torch.cat([old_aux, torch.stack([new_scale, new_bias], dim=1)]),
        all_ids, all_labels, index.n_lists, _GROUP, pow2_chunks=True)
    return IvfBqIndex(
        index.centers, index.rotation, list_codes, list_ids,
        aux[:, :, 0].contiguous(),
        torch.where(list_ids >= 0, aux[:, :, 1], float("inf")).contiguous(),
        index.metric, index.bits, index.rotation_kind)


def _scatter_chunk_bq(list_codes, list_ids, list_scale, list_bias, codes,
                      scale, bias, labels, base, row_start: int) -> None:
    """One streamed-build chunk's encoded rows written in place at the
    per-list write offsets ``base`` plus their chunk-local arrival ranks
    (IVF-PQ's :func:`_chunk_positions`: rows with the drop sentinel or
    past the padded size are left out)."""
    n_lists, mls = list_ids.shape
    order, lst, pos = _chunk_positions(labels.to(torch.int64), base, n_lists,
                                       mls)
    list_codes[lst, pos] = codes[order]
    list_ids[lst, pos] = (row_start + order).to(torch.int32)
    list_scale[lst, pos] = scale[order]
    list_bias[lst, pos] = bias[order]


def _encode_chunk_degradable(rows, labels, centers, rotation, metric: str,
                             bits: int, rotation_kind: str, sub: int,
                             floor: int = 4096):
    """One streamed chunk through :func:`_encode_rows` in sub-chunks of
    ``sub`` rows, behind the ``ivf_bq.build.encode_chunk`` faultpoint. An
    OOM-classified failure re-encodes the chunk at half the sub-chunk, down
    to ``floor`` (``resilience.degrade_on_oom``), counting
    ``ivf_bq.build.degraded_chunk``: rows are encoded independently, so the
    result is bit-identical, only the launch count grows."""
    m = rows.shape[0]
    # small chunks still get one halving before the floor bites
    floor = max(64, min(floor, m // 2))
    first = min(int(sub), m)

    def attempt(size):
        if size < first:
            obs.add("ivf_bq.build.degraded_chunk")
            record_event("degraded_chunk", site="ivf_bq.build.encode_chunk",
                         chunk_rows=size)
        faultpoint("ivf_bq.build.encode_chunk")
        return _encode_rows(rows, labels, centers, rotation, metric, bits,
                            rotation_kind, chunk=size)

    return degrade_on_oom(attempt, first, floor=min(first, floor),
                          site="ivf_bq.build.encode_chunk")


@traced("ivf_bq::build_streaming")
def build_streaming(chunk_fn: Callable[[int, int], Any], n: int, dim: int,
                    params: IvfBqParams = IvfBqParams(),
                    res: Optional[Resources] = None,
                    device: Optional[DeviceLike] = None,
                    chunk_rows: int = 0, train_rows: int = 0) -> IvfBqIndex:
    """Out-of-memory build: the dataset visits the device one chunk at a
    time. ``chunk_fn(start, end)`` returns rows ``start:end`` (numpy or a
    tensor, any device); it is called for a training sample and once per
    chunk in each of two passes, so it must be deterministic.

    * the coarse centers train on ``train_rows`` rows (default ≤ 2M, a
      slice from every chunk; ``>= n`` reads the whole dataset in order);
    * pass 1 assigns each chunk; under the list cap a row whose nearest
      list is full goes to its second-nearest (:func:`_packing.
      assign_top2`, :func:`_packing.divert_to_cap`), and a row whose
      second choice is full too is dropped and counted
      (``index._streaming_dropped``);
    * pass 2 encodes each chunk (:func:`_encode_chunk_degradable`, in
      sub-chunks whose (rows, rot_dim) fp32 temporaries fit
      ``res.workspace_bytes``, halved on an OOM) and writes it at
      precomputed per-list offsets into the preallocated lists
      (:func:`_scatter_chunk_bq`), in place.

    ``index.build_timings_s`` holds the seconds of training, pass 1 and
    pass 2. Cosine needs normalized chunks: normalize inside ``chunk_fn``
    and build with inner_product."""
    res = resources_for(device, res)
    dev = res.device
    if params.metric == "cosine":
        raise ValueError("build_streaming: cosine needs normalized chunks; "
                         "normalize inside chunk_fn and use inner_product")
    rot_dim = auto_rot_dim(dim, params.rotation_kind)
    n_lists = params.n_lists
    km_metric = ("inner_product" if params.metric == "inner_product"
                 else "sqeuclidean")
    km = kmeans_balanced.KMeansBalancedParams(
        n_iters=params.kmeans_n_iters, metric=km_metric, seed=params.seed)
    chunk = int(chunk_rows) or int(
        max(262_144, min(n, res.workspace_bytes // max(dim * 12, 1))))
    chunk = min(chunk, n)
    starts = list(range(0, n, chunk))
    cap = params.list_size_cap
    if cap < 0:
        cap = _packing.auto_list_cap(n, n_lists, _GROUP)

    def rows_of(s, e):
        return torch.as_tensor(chunk_fn(s, e)).to(dev).to(torch.float32)

    t0 = time.perf_counter()
    _, g_rot = kmeans_balanced.seeded_generators(params.seed, 2, dev)
    rotation = _make_rotation(g_rot, rot_dim, params.rotation_kind, dev)
    t_rows = int(train_rows) or int(min(2_000_000, max(
        n_lists * 32, n * params.kmeans_trainset_fraction)))
    t_rows = min(t_rows, n)
    with obs.record_span("ivf_bq::coarse_train"):
        if t_rows >= n:
            trainset = torch.cat([rows_of(s, min(s + chunk, n))
                                  for s in starts])
        else:
            per = max(1, t_rows // len(starts))
            trainset = torch.cat([rows_of(s, min(s + per, n))
                                  for s in starts])
        centers = kmeans_balanced.fit(trainset, n_lists, km, res=res)
        del trainset
    if obs.enabled():
        obs.add("ivf_bq.build.rows", n)
        obs.add("ivf_bq.build.lists", params.n_lists)
        obs.add("ivf_bq.build.streamed_chunks", len(starts))
    _sync(dev)
    t1 = time.perf_counter()

    # pass 1: streamed assignment, diverted under the cap
    run = torch.zeros(n_lists, dtype=torch.int64, device=dev)
    counts, labels_chunks = [], []
    for s in starts:
        check_interrupt()
        rows = rows_of(s, min(s + chunk, n))
        if cap:
            l1, l2_ = _packing.assign_top2(rows, centers, metric=km_metric)
            labels = _packing.divert_to_cap(l1, l2_, run, cap, n_lists)
        else:
            labels = kmeans_balanced.predict(rows, centers, km, res=res)
        labels_chunks.append(labels)
        c = torch.bincount(labels.to(torch.int64).clamp(max=n_lists),
                           minlength=n_lists + 1)
        counts.append(c[:n_lists])
        run += c[:n_lists]
        del rows
    counts_np = torch.stack(counts).cpu().numpy()
    dropped = n - int(counts_np.sum())
    mls = _packing.round_list_size(int(counts_np.sum(axis=0).max()), _GROUP,
                                   pow2_chunks=True)
    base_np = np.cumsum(counts_np, axis=0) - counts_np    # per-chunk offsets
    if dropped:
        _log.warning(
            "ivf_bq.build_streaming: %d row(s) overflowed both their nearest "
            "and second-nearest capped lists and were dropped (cap=%d); "
            "raise list_size_cap or n_lists.", dropped, cap)
    _sync(dev)
    t2 = time.perf_counter()

    # pass 2: encode and write each chunk at its offsets
    sub = max(4096, res.workspace_bytes // (16 * rot_dim * 4))
    list_codes = torch.zeros(
        (n_lists, mls, bq_scan.multibit_width(rot_dim, params.bits)),
        dtype=torch.uint8, device=dev)
    list_ids = torch.full((n_lists, mls), -1, dtype=torch.int32, device=dev)
    list_scale = torch.zeros((n_lists, mls), device=dev)
    list_bias = torch.full((n_lists, mls), float("inf"), device=dev)
    for ci, s in enumerate(starts):
        check_interrupt()
        labels = labels_chunks[ci]
        e = min(s + chunk, n)
        with obs.record_span("ivf_bq::encode_chunk",
                             attrs=({"rows": int(e - s), "chunk": ci}
                                    if obs.enabled() else None)):
            codes, scale, bias = _encode_chunk_degradable(
                rows_of(s, e), labels.to(torch.int64).clamp(max=n_lists - 1),
                centers, rotation, params.metric, params.bits,
                params.rotation_kind, sub)
            _scatter_chunk_bq(list_codes, list_ids, list_scale, list_bias,
                              codes, scale, bias, labels,
                              torch.from_numpy(base_np[ci]).to(dev), s)
    _sync(dev)
    t3 = time.perf_counter()
    return IvfBqIndex(centers, rotation, list_codes, list_ids, list_scale,
                      list_bias, params.metric, params.bits,
                      params.rotation_kind,
                      {"train": t1 - t0, "assign": t2 - t1,
                       "encode": t3 - t2}, dropped)


def reconstruct_rows(centers, rotation, codes, scale, labels, bits: int = 1,
                     rotation_kind: str = "dense",
                     dim: Optional[int] = None) -> torch.Tensor:
    """Approximate input vectors from packed codes: ``c_label +
    R⁻¹(f·L)``, the estimator's projection of the rotated residual on its
    own code levels. Assignment-grade, not exact."""
    rot_dim = int(rotation.shape[-1])
    if bits == 1:
        levels = bq_scan.unpack_sign_bits(codes, rot_dim)
    else:
        levels = bq_scan.unpack_code_levels(codes, rot_dim, bits)
    u_hat = scale.to(torch.float32)[:, None] * levels.to(torch.float32)
    resid = linalg.unrotate_rows(u_hat, rotation, rotation_kind)
    d = int(centers.shape[1]) if dim is None else int(dim)
    return centers[labels.to(torch.int64)] + resid[:, :d]


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
              q_tile: int, filter=None):
    """Prep, device plan, packed strip scan (tournament allowed: the path
    over-fetches and re-ranks exactly) and finalize (‖Rq̃‖² = ‖q‖²). A
    filter turns its failing ids' bias lanes to +inf."""
    obs_compile.trace_event(
        _LEDGER_ENTRY, queries=queries, centers=index.centers,
        rotation=index.rotation, list_codes=index.list_codes,
        list_scale=index.list_scale, list_bias=index.list_bias,
        list_ids=index.list_ids, filter=filter, cls_ord=cls_ord,
        static={"k": k, "n_probes": n_probes, "metric": index.metric,
                "select_algo": select_algo, "classes": classes,
                "class_counts": class_counts, "q_tile": q_tile,
                "bits": index.bits, "rotation_kind": index.rotation_kind})
    probes, qr, pair_const = _bq_search_prep(
        queries, index.centers, index.rotation, n_probes, select_algo, l2,
        index.bits, index.rotation_kind)
    bias = _filtering.apply_filter_bias(index.list_bias, index.list_ids,
                                        filter)
    vals, ids = bq_scan.bq_strip_search_traced(
        qr, probes, index.list_codes, index.list_scale, bias,
        index.list_ids, cls_ord, classes, class_counts, int(k), int(k),
        -2.0 if l2 else -1.0, q_tile, pair_const=pair_const, approx_ok=True)
    return _finalize_ragged(vals, ids, queries, index.metric)


@traced("ivf_bq::search")
def search(index: IvfBqIndex, queries, k: int, n_probes: int = 20,
           filter=None, select_algo: str = "exact",
           res: Optional[Resources] = None,
           device: Optional[DeviceLike] = None):
    """Approximate k-NN over the packed lists → (distances (q, k) fp32, ids
    (q, k) int32). Distances are unbiased estimates, not exact: re-rank
    with :func:`search_refined` for the recall-gated configuration.
    ``filter``: a :class:`~raft_tpu_torch.core.bitset.Bitset` over source
    ids; n_probes widens by its selectivity. An OOM-classified failure of
    the scan runs it again at half the query tile, down to 64 rows
    (``resilience.degrade_on_oom``; ``ivf_bq.search.degraded_tile``
    counts each halving): the result is the same."""
    res = resources_for(device, res)
    if index.device != res.device:
        raise ValueError(f"index lives on {index.device}, search runs on "
                         f"{res.device}; move it with index.to(device)")
    queries = torch.as_tensor(queries).to(device=res.device, dtype=torch.float32)
    if queries.ndim != 2 or queries.shape[1] != index.dim:
        raise ValueError(f"queries must be (q, {index.dim}), got {tuple(queries.shape)}")
    n_probes = int(min(n_probes, index.n_lists))
    n_probes, filter_attrs = _filter_plan("ivf_bq.search.filter", filter,
                                          n_probes, index.n_lists)
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
    q_tile = min(q_tile, queries.shape[0])
    scan_attrs = None
    if obs.enabled():
        q = int(queries.shape[0])
        # the JAX package's names: "packed" is the kernel (K2 here),
        # "reference" its plain twin (CPU tensors)
        scan_attrs = _scan_telemetry(
            "ivf_bq.search", "packed" if queries.is_cuda else "reference", q,
            n_probes, k, filter_attrs)
        # the packed scan's FLOP/byte model, with the strip planner's
        # occupancy at the scan's planning width (bits·rot_dim)
        lens_cached = getattr(index, "_lens_np_cache", None)
        occ = None
        if lens_cached is not None \
                and lens_cached.shape[0] == index.n_lists:
            kf_occ = min(int(k), 512)
            occ = obs_roofline.memo_occupancy(
                index,
                (id(lens_cached), q, int(n_probes), kf_occ,
                 res.workspace_bytes),
                lambda: bq_scan.occupancy_stats(
                    lens_cached, index.max_list_size, q, n_probes,
                    rot_dim=index.rot_dim,
                    workspace_bytes=res.workspace_bytes, kf=kf_occ,
                    bits=index.bits))
        obs_roofline.note_dispatch(
            "ivf_bq.search",
            {"q": q, "dim": index.dim, "n_lists": index.n_lists,
             "max_list_size": index.max_list_size,
             "n_probes": int(n_probes), "k": int(k),
             "rot_dim": index.rot_dim, "bits": index.bits,
             "rotation_kind": index.rotation_kind},
            occupancy=occ)

    def attempt(qt):
        if qt < q_tile:
            obs.add("ivf_bq.search.degraded_tile")
        faultpoint("ivf_bq.search.scan")
        with obs.record_span("ivf_bq::scan", attrs=scan_attrs), \
                obs_compile.watch():
            return _bq_fused(queries, index, int(k), n_probes, select_algo,
                             l2, classes, class_counts, cls_ord, qt, filter)

    return degrade_on_oom(attempt, q_tile, floor=min(q_tile, 64),
                          site="ivf_bq.search.scan")


@traced("ivf_bq::search_refined")
def search_refined(index: IvfBqIndex, dataset, queries, k: int,
                   n_probes: int = 20, refine_ratio: int = 4, filter=None,
                   res: Optional[Resources] = None,
                   device: Optional[DeviceLike] = None):
    """The recall-gated configuration: over-fetch ``k·refine_ratio``
    estimated candidates (at most 512), then re-rank them exactly against
    ``dataset``, the caller's original rows. A filter widens the
    over-fetch by its selectivity too (still at most 512)."""
    if refine_ratio < 1:
        raise ValueError(f"refine_ratio must be >= 1, got {refine_ratio}")
    res = resources_for(device, res)
    k_fetch = min(int(k) * int(refine_ratio), 512)
    if filter is not None:
        k_fetch = _filtering.widen_plan(filter, n_probes, index.n_lists,
                                        k_fetch=k_fetch, k_cap=512)[1]
    _, cand = search(index, queries, k_fetch, n_probes=n_probes,
                     filter=filter, res=res)
    return refine.refine(dataset, queries, cand, int(k), metric=index.metric,
                         res=res)


# ---------------------------------------------------------------------------
# Paged search (serving): K4 over a PagedListStore's code pools
# ---------------------------------------------------------------------------


def _paged_fused_bq(queries, store, codes_pool, scale_pool, bias_pool,
                    page_ids, table, chain_pages, k: int, n_probes: int,
                    select_algo: str, q_tile: int,
                    class_impl=bq_scan.paged_bq_class):
    """The packed path's prep (probes, plane-extended rotated queries, the
    exact pair term), K4 over the store's code, scale and bias pools in
    place (``class_impl``: K4's wrapper, or its plain twin), merge and
    finalize. No tournament: the paged scan runs the exact carry."""
    obs_compile.trace_event(
        "ivf_bq.paged_pallas", queries=queries, centers=store.centers,
        rotation=store.rotation, codes_pool=codes_pool,
        scale_pool=scale_pool, bias_pool=bias_pool, page_ids=page_ids,
        table=table, chain_pages=chain_pages,
        static={"k": k, "n_probes": n_probes, "metric": store.metric,
                "select_algo": select_algo, "q_tile": q_tile,
                "impl": getattr(class_impl, "__name__", "paged_bq_class"),
                "bits": store.bq_bits,
                "rotation_kind": store.rotation_kind})
    l2 = store.metric in ("sqeuclidean", "euclidean")
    probes, qr, pair_const = _bq_search_prep(
        queries, store.centers, store.rotation, n_probes, select_algo, l2,
        store.bq_bits, store.rotation_kind)
    vals, ids = bq_scan.paged_bq_search_traced(
        qr, probes, codes_pool, scale_pool, bias_pool, page_ids, table,
        chain_pages, int(k), int(k), -2.0 if l2 else -1.0, q_tile,
        pair_const=pair_const, class_impl=class_impl)
    return _finalize_ragged(vals, ids, queries, store.metric)


@traced("ivf_bq::search_paged")
def search_paged(store, queries, k: int, n_probes: int = 20, filter=None,
                 select_algo: str = "exact", backend: str = "auto",
                 res: Optional[Resources] = None,
                 device: Optional[DeviceLike] = None):
    """Approximate k-NN over a mutable paged code store (``PagedListStore``
    of kind ``"ivf_bq"``): :func:`search`'s estimator contract while rows
    stream in and out, k ≤ min(n_probes·table_width·page_rows, 512).
    ``backend``: "paged" (K4 over the store's pools), "auto" (the same;
    ``ValueError`` naming why when the store's plan cannot feed k) or
    "paged_jnp" (K4's plain twin on any device, only when named).
    ``filter`` (else the store's standing one) is an +inf bias lane.
    Re-rank with :func:`raft_tpu_torch.neighbors.refine.refine`."""
    res, n_probes, queries, filter, backend, filter_attrs = \
        _paged_search_args(store, "ivf_bq", queries, k, n_probes, filter,
                           backend, res, device, k_cap=512,
                           backends=PAGED_BACKENDS)
    codes_pool, bias_pool, scale_pool, page_ids, table, chain_pages = \
        store.paged_scan_state()
    bias_pool = _filtering.apply_filter_bias(bias_pool, page_ids, filter)
    rot_dim = int(store.rotation.shape[0])
    q_tile = min(_paged_plan_static(store, n_probes, k, res,
                                    rot_dim * store.bq_bits),
                 queries.shape[0])
    with _paged_scan_span(store, backend, int(queries.shape[0]), n_probes, k,
                          filter_attrs, res):
        return _paged_fused_bq(queries, store, codes_pool, scale_pool,
                               bias_pool, page_ids, table, chain_pages,
                               int(k), n_probes, select_algo, q_tile,
                               bq_scan._paged_bq_class_plain
                               if backend == "paged_jnp"
                               else bq_scan.paged_bq_class)
