"""IVF-PQ: inverted lists of product-quantized residuals (counterpart of
``raft_tpu/neighbors/ivf_pq.py``).

The score algebra is the JAX package's, for L2:

    d²(q, x ∈ list l) = ‖q‖² − 2⟨q, c_l⟩ − 2⟨Rq, r̂⟩ + ‖R·c_l + r̂‖²

with ``r̂`` the decoded residual in rotated space. Three search backends
read it (``search(backend=...)``, resolved by :func:`resolve_backend`):

* ``"ragged"`` scans an int8 cache of ``r̂`` (``_decode_lists``) through
  the strip kernel K1 with the query operand ``Rq·scale``; ``‖R·c_l +
  r̂‖²`` is the per-entry bias (``‖R·c_l‖² + b_sum``), the exact
  ``−2⟨q, c_l⟩`` pair term is added at the merge, and ``‖q‖²`` at the end;
* ``"pallas"`` (the JAX package's name) is the lookup-table scan: a bf16
  per-query table ``−2⟨(Rq)_s, cb[s, c]⟩`` gathered per list onto the
  queries probing it, scanned by kernel K5 (:mod:`raft_tpu_torch.ops.
  pq_scan`) with ``b_sum`` as the list-side half;
* ``"gather"`` is the same table in fp32 looked up with plain tensor ops,
  per query tile.

Candidates are meant for exact re-ranking
(:mod:`raft_tpu_torch.neighbors.refine`). Builds: :func:`build` with
per-subspace or per-cluster codebooks, the out-of-memory
:func:`build_streaming` (packed codes, or only a truncated int8 cache),
:func:`extend`; :func:`reconstruct_rows` decodes rows back to the input
space; :func:`search_paged` scans a ``PagedListStore`` through K3, or
with the gather backend's lookup over the page table where K3's plan
cannot feed k. ``filter`` rides every backend: an +inf bias lane for K1
and K3, a mask on K5's scores before the select over p·m, a validity mask
on the gather.

Telemetry and fault injection are the JAX package's: ``ivf_pq::build``
(phases ``coarse_train``, ``codebook_train``, ``encode`` → ``encode_tile``,
``pack``), ``ivf_pq::build_streaming`` (``check_interrupt`` before every
chunk), ``ivf_pq::search`` → ``ivf_pq::scan`` and
``ivf_pq::search_paged`` → ``paged_pallas`` / ``paged_scan`` spans;
``ivf_pq.build.*``, ``ivf_pq.search.*`` and ``ivf_pq.search_paged.*``
counters; the ``ivf_pq.search.filter``, ``.search.scan`` and
``.search_paged.scan`` faultpoints.
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
from raft_tpu_torch.neighbors import _filtering, _packing
from raft_tpu_torch.neighbors.ivf_flat import (_filter_plan,
                                               _finalize_ragged,
                                               _page_gather,
                                               _paged_plan_static,
                                               _paged_scan_span,
                                               _paged_search_args,
                                               _ragged_plan_static,
                                               _scan_telemetry)
from raft_tpu_torch.ops import pq_scan, strip_scan
from raft_tpu_torch.ops.distance import (canonical_metric,
                                         expanded_sqeuclidean, matmul_t,
                                         sqnorm)
from raft_tpu_torch.ops import linalg
from raft_tpu_torch.ops.linalg import rotate_rows, unrotate_rows
from raft_tpu_torch.ops.select_k import select_k
from raft_tpu_torch.resilience import faultpoint

SUPPORTED_METRICS = ("sqeuclidean", "euclidean", "inner_product", "cosine")

# the rotation helpers live in ops/linalg; these keep the JAX package's
# public names importable from here
make_rotation_matrix = linalg.make_rotation_matrix
pad_rot = linalg.pad_rot
BACKENDS = ("auto", "ragged", "pallas", "gather")
_log = logging.getLogger("raft_tpu_torch")


@dataclass(frozen=True)
class IvfPqParams:
    n_lists: int = 1024
    pq_dim: int = 0                 # 0 = auto: dim/2 rounded up to 8
    pq_bits: int = 8                # codebook size 2**pq_bits, 4..8
    codebook_kind: str = "subspace"
    metric: str = "sqeuclidean"
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    codebook_n_iters: int = 25
    list_size_cap: int = -1         # -1 auto (4× mean), 0 off
    group_size: int = 0             # list padding granule; 0 auto
    seed: int = 0

    def __post_init__(self):
        m = canonical_metric(self.metric)
        if m not in SUPPORTED_METRICS:
            raise ValueError(f"ivf_pq supports {SUPPORTED_METRICS}, got {self.metric!r}")
        object.__setattr__(self, "metric", m)
        if not 4 <= self.pq_bits <= 8:
            raise ValueError(f"pq_bits must be in [4, 8], got {self.pq_bits}")
        if self.codebook_kind not in ("subspace", "cluster"):
            raise ValueError(f"codebook_kind must be 'subspace'|'cluster', got "
                             f"{self.codebook_kind!r}")


@dataclass
class IvfPqIndex:
    """Coarse centers, rotation, codebooks and packed code lists;
    ``list_ids == -1`` marks padding, ``b_sum`` is +inf there. A
    cache-only streamed index (``build_streaming(store="cache")``) has
    codes of width 0 and keeps only ``decoded``."""

    centers: torch.Tensor      # (n_lists, dim) fp32
    rotation: torch.Tensor     # (rot_dim, rot_dim) fp32, orthogonal
    codebooks: torch.Tensor    # (pq_dim | n_lists, n_codes, dsub) fp32
    list_codes: torch.Tensor   # (n_lists, m, packed_width) uint8
    list_ids: torch.Tensor     # (n_lists, m) int32
    b_sum: torch.Tensor        # (n_lists, m) fp32
    metric: str = "sqeuclidean"
    pq_bits: int = 8
    group_size: int = 0
    codebook_kind: str = "subspace"   # or "cluster": one codebook per list
    pq_dim_hint: int = 0
    # int8 residual cache (n_lists, m, cache_dim) and its fp32 scale:
    # derived data, filled at the first ragged search and never serialized,
    # except on a cache-only index, where it is the payload
    decoded: Optional[torch.Tensor] = None
    decoded_scale: Optional[torch.Tensor] = None
    # seconds by phase of build_streaming; rows it dropped at the cap
    build_timings_s: Optional[Dict[str, float]] = None
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
    def pq_dim(self) -> int:
        return self.pq_dim_hint or self.codebooks.shape[0]

    @property
    def n_codes(self) -> int:
        return self.codebooks.shape[1]

    @property
    def max_list_size(self) -> int:
        return self.list_codes.shape[1]

    @property
    def cache_only(self) -> bool:
        """True for a streamed index that keeps no codes, only the cache."""
        return self.list_codes.shape[-1] == 0

    @property
    def device(self) -> torch.device:
        return self.centers.device

    @property
    def size(self) -> int:
        return int((self.list_ids >= 0).sum())

    def list_sizes(self) -> torch.Tensor:
        return (self.list_ids >= 0).sum(dim=1).to(torch.int32)

    def to(self, device: DeviceLike) -> "IvfPqIndex":
        """A copy of the index with its tensors on ``device``."""
        dev = torch.device(device)

        def move(t):
            return None if t is None else t.to(dev)

        return IvfPqIndex(
            self.centers.to(dev), self.rotation.to(dev),
            self.codebooks.to(dev), self.list_codes.to(dev),
            self.list_ids.to(dev), self.b_sum.to(dev), self.metric,
            self.pq_bits, self.group_size, self.codebook_kind,
            self.pq_dim_hint, move(self.decoded), move(self.decoded_scale),
            self.build_timings_s, self._streaming_dropped)

    def arrays(self) -> Dict[str, torch.Tensor]:
        return {"centers": self.centers, "rotation": self.rotation,
                "codebooks": self.codebooks, "list_codes": self.list_codes,
                "list_ids": self.list_ids, "b_sum": self.b_sum}

    def meta(self) -> Dict[str, Any]:
        return {"kind": "ivf_pq", "metric": self.metric,
                "pq_bits": self.pq_bits, "group_size": self.group_size,
                "codebook_kind": self.codebook_kind,
                "pq_dim_hint": self.pq_dim_hint}

    def save(self, path) -> None:
        """Write the v2 container both packages read. A cache-only index
        raises ``ValueError``: the container holds codes, not the cache,
        and the JAX package cannot search such a file once loaded."""
        if self.cache_only:
            raise ValueError(
                "a cache-only streamed index (build_streaming store='cache') "
                "keeps no codes, and the index file holds codes, not the "
                "int8 cache: the file would load as an index neither package "
                "can search; rebuild with store='codes' to save")
        save_arrays(path, self.meta(), self.arrays())

    @classmethod
    def load(cls, path, device: Optional[DeviceLike] = None,
             res: Optional[Resources] = None) -> "IvfPqIndex":
        """Read an ``ivf_pq`` container written by either package."""
        meta, arrays = load_arrays(path)
        return from_jax_arrays(meta, arrays, device=device, res=res)


def from_jax_arrays(meta: Mapping[str, Any], arrays: Mapping[str, Any],
                    device: Optional[DeviceLike] = None,
                    res: Optional[Resources] = None) -> IvfPqIndex:
    """An index from the JAX package's arrays (``centers``, ``rotation``,
    ``codebooks``, ``list_codes``, ``list_ids``, ``b_sum`` as numpy or
    anything ``np.asarray`` takes) and its container meta
    (``pq_dim_hint`` names pq_dim for per-cluster codebooks). The int8
    search cache is rebuilt from the codes at the first search; a
    cache-only index (codes of width 0) also needs ``decoded`` and
    ``decoded_scale``."""
    if meta.get("kind", "ivf_pq") != "ivf_pq":
        raise ValueError(f"not an ivf_pq index: {meta.get('kind')}")
    dev = resources_for(device, res).device

    def t(name):
        return torch.from_numpy(np.array(arrays[name])).to(dev)

    decoded = scale = None
    if np.shape(arrays["list_codes"])[-1] == 0:
        if "decoded" not in arrays or "decoded_scale" not in arrays:
            raise ValueError("a cache-only index needs its 'decoded' cache "
                             "and 'decoded_scale'")
        decoded, scale = t("decoded"), t("decoded_scale").to(torch.float32)
    return IvfPqIndex(
        t("centers"), t("rotation"), t("codebooks"), t("list_codes"),
        t("list_ids"), t("b_sum"), meta.get("metric", "sqeuclidean"),
        int(meta.get("pq_bits", 8)), int(meta.get("group_size", 0)),
        meta.get("codebook_kind", "subspace"),
        int(meta.get("pq_dim_hint", 0)), decoded, scale)


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------


def _auto_pq_dim(dim: int) -> int:
    pq = max(1, dim // 2)
    return -(-pq // 8) * 8 if pq >= 8 else pq


def packed_width(pq_dim: int, pq_bits: int) -> int:
    return -(-pq_dim * pq_bits // 8)


def pack_codes(codes: torch.Tensor, pq_bits: int) -> torch.Tensor:
    """(…, pq_dim) uint8 codes → (…, ceil(pq_dim·bits/8)) little-endian
    bit-packed uint8."""
    if pq_bits == 8:
        return codes
    pq_dim = codes.shape[-1]
    nbytes = packed_width(pq_dim, pq_bits)
    c32 = codes.to(torch.int64)
    out = torch.zeros(codes.shape[:-1] + (nbytes,), dtype=torch.int64,
                      device=codes.device)
    for s in range(pq_dim):
        bit0 = s * pq_bits
        byte, r = bit0 >> 3, bit0 & 7
        out[..., byte] |= (c32[..., s] << r) & 0xFF
        if byte + 1 < nbytes and r + pq_bits > 8:
            out[..., byte + 1] |= c32[..., s] >> (8 - r)
    return out.to(torch.uint8)


def unpack_codes(packed: torch.Tensor, pq_dim: int, pq_bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes` → (…, pq_dim) uint8."""
    if pq_bits == 8:
        return packed
    nbytes = packed.shape[-1]
    p = packed.to(torch.int64)
    bit0 = torch.arange(pq_dim, device=packed.device) * pq_bits
    byte, r = bit0 >> 3, bit0 & 7
    lo = p[..., byte] >> r
    hi = p[..., (byte + 1).clamp(max=nbytes - 1)] << (8 - r)
    hi = torch.where(byte + 1 < nbytes, hi, torch.zeros_like(hi))
    return ((lo | hi) & ((1 << pq_bits) - 1)).to(torch.uint8)


def _codes_view(list_codes: torch.Tensor, pq_dim: int, pq_bits: int):
    if list_codes.shape[-1] == pq_dim:
        return list_codes
    return unpack_codes(list_codes, pq_dim, pq_bits)


def _train_codebooks(resid_sub: torch.Tensor, gen: torch.Generator,
                     n_codes: int, n_iters: int,
                     workspace_bytes: int = 1 << 30) -> torch.Tensor:
    """Per-subspace Lloyd k-means: resid_sub (pq_dim, n_train, dsub) →
    codebooks (pq_dim, n_codes, dsub). Subspaces run batched, as many at a
    time as keep the (·, n_train, n_codes) distance block in budget."""
    pq_dim, n_train, dsub = resid_sub.shape
    dev = resid_sub.device
    rows = torch.randint(0, n_train, (pq_dim, n_codes), generator=gen,
                         device=dev)
    cb = torch.gather(resid_sub, 1, rows[:, :, None].expand(-1, -1, dsub))
    per_sub = max(1, n_train * n_codes * 4)
    step = max(1, min(pq_dim, workspace_bytes // per_sub))
    out = []
    for s0 in range(0, pq_dim, step):
        X = resid_sub[s0:s0 + step]                       # (b, n, d)
        c = cb[s0:s0 + step]
        b = X.shape[0]
        xn = (X * X).sum(-1)
        seg = (torch.arange(b, device=dev) * n_codes)[:, None]
        for _ in range(n_iters):
            d2 = (xn[:, :, None] + (c * c).sum(-1)[:, None, :]
                  - 2.0 * torch.bmm(X, c.transpose(1, 2)))
            labels = d2.argmin(dim=2) + seg                   # (b, n)
            sums = torch.zeros((b * n_codes, dsub), device=dev)
            sums.index_add_(0, labels.reshape(-1), X.reshape(-1, dsub))
            counts = torch.bincount(labels.reshape(-1),
                                    minlength=b * n_codes).to(torch.float32)
            means = (sums / counts.clamp(min=1.0)[:, None]).reshape(b, n_codes, dsub)
            c = torch.where(counts.reshape(b, n_codes, 1) > 0, means, c)
        out.append(c)
    return torch.cat(out, 0)


def _encode(resid_rot: torch.Tensor, codebooks: torch.Tensor,
            chunk: int = 8192) -> torch.Tensor:
    """resid_rot (n, pq_dim, dsub) → (n, pq_dim) uint8 nearest codebook
    entry per subspace, in row chunks."""
    cn = (codebooks * codebooks).sum(-1)                   # (s, c)
    out = []
    for s in range(0, resid_rot.shape[0], chunk):
        rows = resid_rot[s:s + chunk]
        ip = torch.einsum("nsd,scd->nsc", rows, codebooks)
        out.append((cn[None] - 2.0 * ip).argmin(dim=2).to(torch.uint8))
    return torch.cat(out, 0)


def _train_codebooks_cluster(resid_sub: torch.Tensor, labels: torch.Tensor,
                             gen: torch.Generator, n_codes: int, n_iters: int,
                             n_lists: int) -> torch.Tensor:
    """Per-cluster Lloyd k-means: one (n_codes, dsub) codebook per list,
    trained on all sub-vectors of that list's residuals pooled across
    subspaces. resid_sub (n_train, pq_dim, dsub), labels (n_train,) →
    (n_lists, n_codes, dsub). Seeds: per list, ``min(n_codes, 8)`` random
    member sub-vectors (the member with the largest uniform draw), then
    jittered copies of them up to ``n_codes``, as in the JAX package."""
    n_train, pq_dim, dsub = resid_sub.shape
    dev = resid_sub.device
    sub = resid_sub.reshape(n_train * pq_dim, dsub)
    n_sub = sub.shape[0]
    sub_label = labels.to(torch.int64).repeat_interleave(pq_dim)
    n_seed = min(n_codes, 8)
    u = torch.rand((n_seed, n_sub), generator=gen,
                   device=gen.device).to(dev)
    pos = torch.arange(n_sub, device=dev)
    seeds = []
    for c in range(n_seed):
        top = torch.full((n_lists,), float("-inf"), device=dev).scatter_reduce(
            0, sub_label, u[c], "amax")
        rep = torch.full((n_lists,), n_sub - 1, dtype=torch.int64,
                         device=dev).scatter_reduce(
            0, sub_label, torch.where(u[c] >= top[sub_label], pos, n_sub - 1),
            "amin")
        seeds.append(sub[rep])
    cb = torch.stack(seeds, dim=1)                        # (L, n_seed, d)
    if n_codes > n_seed:   # jittered copies of the seeds: Lloyd separates them
        reps = -(-n_codes // n_seed)
        noise = torch.randn((n_lists, n_seed * reps, dsub), generator=gen,
                            device=gen.device).to(dev) * 0.05
        spread = torch.std(sub, correction=0) + 1e-6
        cb = (cb.repeat(1, reps, 1) + noise * spread)[:, :n_codes]
    nseg = n_lists * n_codes
    chunk = max(256, min(n_train, 4_000_000 // max(pq_dim * n_codes, 1)))
    for _ in range(n_iters):
        codes = []
        for s in range(0, n_train, chunk):
            cb_l = cb[labels[s:s + chunk].to(torch.int64)]   # (n, c, d)
            d2 = ((cb_l * cb_l).sum(2)[:, None, :]
                  - 2.0 * torch.einsum("nsd,ncd->nsc", resid_sub[s:s + chunk],
                                       cb_l))
            codes.append(d2.argmin(dim=2))
        seg = sub_label * n_codes + torch.cat(codes, 0).reshape(-1)
        sums = torch.zeros((nseg, dsub), device=dev).index_add_(0, seg, sub)
        cnts = torch.bincount(seg, minlength=nseg).to(torch.float32)
        new = (sums / cnts.clamp(min=1.0)[:, None]).reshape(n_lists, n_codes,
                                                            dsub)
        cb = torch.where(cnts.reshape(n_lists, n_codes, 1) > 0, new, cb)
    return cb


def _encode_cluster(resid_rot: torch.Tensor, labels: torch.Tensor,
                    codebooks: torch.Tensor, chunk: int = 8192) -> torch.Tensor:
    """Per-cluster encode: each row's subspaces score against its own
    list's codebook → (n, pq_dim) uint8."""
    cn = (codebooks * codebooks).sum(-1)                   # (L, c)
    out = []
    for s in range(0, resid_rot.shape[0], chunk):
        lb = labels[s:s + chunk].to(torch.int64)
        ip = torch.einsum("nsd,ncd->nsc", resid_rot[s:s + chunk],
                          codebooks[lb])
        out.append((cn[lb][:, None, :] - 2.0 * ip).argmin(dim=2)
                   .to(torch.uint8))
    return torch.cat(out, 0)


def _encode_rows(resid_rot, labels, codebooks, cluster: bool):
    """Codes of rotated residual rows (n, pq_dim, dsub) under either
    codebook kind."""
    if cluster:
        return _encode_cluster(resid_rot, labels, codebooks)
    return _encode(resid_rot, codebooks)


def _list_chunks(n_lists: int, per_list: int, budget: int = 256 << 20):
    step = max(1, budget // max(1, per_list))
    return [(s, min(n_lists, s + step)) for s in range(0, n_lists, step)]


def _decode_lists(codebooks: torch.Tensor, list_codes: torch.Tensor,
                  pq_dim: int, pq_bits: int, cluster: bool = False):
    """The int8 residual cache: per entry the codebook rows of its codes,
    quantized at scale max|codebooks|/127 → (cache (n_lists, m, rot_dim)
    int8, 0-d fp32 scale). ``cluster`` reads list l's codes in codebook
    l."""
    scale = torch.clamp(codebooks.abs().max(), min=1e-30) / 127.0
    return _decode_lists_scaled(codebooks, list_codes, scale, pq_dim,
                                pq_bits, cluster), scale


def _decode_lists_scaled(codebooks, list_codes, scale, pq_dim: int,
                         pq_bits: int, cluster: bool = False):
    n_lists, m = list_codes.shape[0], list_codes.shape[1]
    _, n_codes, dsub = codebooks.shape
    rot_dim = pq_dim * dsub
    cb_q = torch.clamp(torch.round(codebooks / scale), -127, 127).to(torch.int8)
    s_off = torch.arange(pq_dim, device=codebooks.device) * n_codes
    out = torch.empty((n_lists, m, rot_dim), dtype=torch.int8,
                      device=codebooks.device)
    for a, b in _list_chunks(n_lists, m * pq_dim * 8):
        codes = _codes_view(list_codes[a:b], pq_dim, pq_bits).to(torch.int64)
        if cluster:
            lists = torch.arange(a, b, device=codes.device)[:, None, None]
            out[a:b] = cb_q[lists, codes].reshape(b - a, m, rot_dim)
        else:
            out[a:b] = cb_q.reshape(pq_dim * n_codes, dsub)[
                codes + s_off].reshape(b - a, m, rot_dim)
    return out


def _b_table(centers, rotation, codebooks, pq_dim: int,
             cluster: bool = False) -> torch.Tensor:
    """(n_lists, pq_dim·n_codes) list-side LUT half: entry (l, s·n_codes +
    c) is 2·(R·c_l)_s·cb[s, c] + ‖cb[s, c]‖² (codebook l for ``cluster``)."""
    n_lists = centers.shape[0]
    dsub = codebooks.shape[2]
    rc = rotate_rows(centers, rotation).reshape(n_lists, pq_dim, dsub)
    cn = (codebooks * codebooks).sum(-1)
    if cluster:
        B = 2.0 * torch.einsum("lsd,lcd->lsc", rc, codebooks) + cn[:, None, :]
    else:
        B = 2.0 * torch.einsum("lsd,scd->lsc", rc, codebooks) + cn[None]
    return B.reshape(n_lists, -1)


def _compute_b_sum(centers, rotation, codebooks, list_codes, list_ids,
                   metric: str, pq_dim: int, pq_bits: int = 8,
                   cluster: bool = False):
    """Per entry Σ_s (2·(R·c_l)_s·cb[s, code] + ‖cb[s, code]‖²) for L2,
    zeros for inner-product metrics; +inf at padding."""
    n_lists, m = list_codes.shape[0], list_codes.shape[1]
    pad_inf = torch.where(list_ids >= 0, 0.0, float("inf")).to(torch.float32)
    if metric in ("inner_product", "cosine"):
        return pad_inf
    n_codes = codebooks.shape[1]
    B = _b_table(centers, rotation, codebooks, pq_dim, cluster)
    s_off = torch.arange(pq_dim, device=centers.device) * n_codes
    out = torch.empty((n_lists, m), dtype=torch.float32, device=centers.device)
    for a, b in _list_chunks(n_lists, m * pq_dim * 12):
        codes = _codes_view(list_codes[a:b], pq_dim, pq_bits).to(torch.int64)
        idx = (codes + s_off).reshape(b - a, m * pq_dim)
        out[a:b] = torch.gather(B[a:b], 1, idx).reshape(b - a, m, pq_dim).sum(-1)
    return out + pad_inf


@traced("ivf_pq::build")
def build(dataset, params: IvfPqParams = IvfPqParams(),
          res: Optional[Resources] = None,
          device: Optional[DeviceLike] = None) -> IvfPqIndex:
    """Train the coarse centers (balanced k-means), a random rotation and
    the codebooks (per subspace, or per list with
    ``codebook_kind="cluster"``); encode and pack the lists."""
    res = resources_for(device, res)
    dev = res.device
    X = torch.as_tensor(dataset).to(device=dev, dtype=torch.float32)
    n, dim = X.shape
    if params.n_lists > n:
        raise ValueError(f"n_lists={params.n_lists} > n_rows={n}")
    pq_dim = params.pq_dim or _auto_pq_dim(dim)
    if pq_dim > dim:
        raise ValueError(f"pq_dim={pq_dim} > dim={dim}")
    dsub = -(-dim // pq_dim)
    rot_dim = pq_dim * dsub
    n_codes = 1 << params.pq_bits

    work = X
    if params.metric == "cosine":
        work = work / torch.clamp(torch.linalg.vector_norm(work, dim=1,
                                                           keepdim=True),
                                  min=1e-30)
    km_metric = ("inner_product" if params.metric in ("cosine", "inner_product")
                 else "sqeuclidean")
    km = kmeans_balanced.KMeansBalancedParams(
        n_iters=params.kmeans_n_iters, metric=km_metric, seed=params.seed)
    g_train, g_rot, g_cb = kmeans_balanced.seeded_generators(params.seed, 3, dev)
    n_train = max(params.n_lists, int(n * params.kmeans_trainset_fraction))
    with obs.record_span("ivf_pq::coarse_train"):
        if n_train < n:
            rows = torch.randint(0, n, (n_train,), generator=g_train,
                                 device=dev)
            trainset = work[rows]
            centers = kmeans_balanced.fit(trainset, params.n_lists, km,
                                          res=res)
            labels = kmeans_balanced.predict(work, centers, km, res=res)
        else:
            trainset = work
            centers, labels = kmeans_balanced.fit_predict(
                work, params.n_lists, km, res=res)

    cluster = params.codebook_kind == "cluster"
    with obs.record_span("ivf_pq::codebook_train"):
        rotation = make_rotation_matrix(g_rot, rot_dim, dev)
        train_labels = kmeans_balanced.predict(trainset, centers, km, res=res)
        resid = rotate_rows(trainset - centers[train_labels], rotation)
        cb_rows = min(resid.shape[0], 65536)
        resid_cb = resid[:cb_rows].reshape(cb_rows, pq_dim, dsub)
        if cluster:
            codebooks = _train_codebooks_cluster(
                resid_cb, train_labels[:cb_rows], g_cb, n_codes,
                params.codebook_n_iters, params.n_lists)
        else:
            codebooks = _train_codebooks(
                resid_cb.transpose(0, 1).contiguous(), g_cb, n_codes,
                params.codebook_n_iters, res.workspace_bytes)
    if obs.enabled():
        obs.add("ivf_pq.build.rows", n)
        obs.add("ivf_pq.build.lists", params.n_lists)

    group = params.group_size or _packing.auto_group_size(n, params.n_lists,
                                                          floor=128)
    cap = params.list_size_cap
    if cap < 0:
        cap = _packing.auto_list_cap(n, params.n_lists, group)
    if cap:
        labels = _packing.spill_to_cap(work, centers, labels, km_metric, cap)

    enc_chunk = int(max(65536, res.workspace_bytes // max(rot_dim * 16, 1)))
    enc_attrs = ({"rows": int(n), "chunk": enc_chunk}
                 if obs.enabled() else None)
    with obs.record_span("ivf_pq::encode", attrs=enc_attrs):
        parts = []
        for s in range(0, n, enc_chunk):
            lch = labels[s:s + enc_chunk]
            with obs.record_span("ivf_pq::encode_tile",
                                 attrs=({"rows": int(lch.shape[0])}
                                        if obs.enabled() else None)):
                r = rotate_rows(work[s:s + enc_chunk] - centers[lch],
                                rotation)
                parts.append(pack_codes(_encode_rows(
                    r.reshape(-1, pq_dim, dsub), lch, codebooks, cluster),
                    params.pq_bits))
        codes = torch.cat(parts, 0)
    with obs.record_span("ivf_pq::pack"):
        row_ids = torch.arange(n, dtype=torch.int32, device=dev)
        list_codes, list_ids = _packing.pack_lists(
            codes, row_ids, labels, params.n_lists, group,
            pow2_chunks=group == 512)
        b_sum = _compute_b_sum(centers, rotation, codebooks, list_codes,
                               list_ids, params.metric, pq_dim,
                               params.pq_bits, cluster)
    return IvfPqIndex(centers, rotation, codebooks, list_codes, list_ids,
                      b_sum, params.metric, params.pq_bits, group,
                      params.codebook_kind, pq_dim)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _chunk_positions(labels, base, n_lists: int, mls: int):
    """Rows of one streamed chunk in label order and their slots: the
    chunk-local arrival rank after the list's write offset ``base``. Rows
    with the drop sentinel (``n_lists``) or past ``mls`` are left out."""
    order, sorted_labels, rank_sorted = _packing.chunk_ranks(labels, n_lists)
    safe = sorted_labels.clamp(max=n_lists - 1)
    pos = base.to(torch.int64)[safe] + rank_sorted
    keep = (sorted_labels < n_lists) & (pos < mls)
    return order[keep], safe[keep], pos[keep]


def _scatter_chunk(list_codes, list_ids, chunk, labels, base, row_start: int,
                   centers, rotation, codebooks, pq_dim: int, pq_bits: int,
                   cluster: bool) -> None:
    """One streamed-build chunk (``store="codes"``): encode and write the
    codes and ids at the precomputed per-list offsets, in place."""
    m = chunk.shape[0]
    n_lists, mls = list_ids.shape
    dsub = codebooks.shape[-1]
    safe = labels.to(torch.int64).clamp(max=n_lists - 1)
    resid = rotate_rows(chunk - centers[safe], rotation).reshape(m, pq_dim,
                                                                 dsub)
    codes = pack_codes(_encode_rows(resid, safe, codebooks, cluster), pq_bits)
    order, lst, pos = _chunk_positions(labels, base, n_lists, mls)
    list_codes[lst, pos] = codes[order]
    list_ids[lst, pos] = (row_start + order).to(torch.int32)


def _scatter_chunk_cache(cache, list_ids, b_sum, chunk, labels, base,
                         row_start: int, centers, rotation, codebooks, rc_t,
                         scale, pq_dim: int, pq_bits: int) -> None:
    """Streamed-build chunk for ``store="cache"``: encode, decode to the
    int8 residual cache truncated to its first ``cache_dim`` rotated
    coordinates, and write cache rows, ids and the truncated-space b_sum
    ``2⟨(R·c_l)[:cd], r̂_t⟩ + ‖r̂_t‖²`` in place. The codes are transient."""
    m = chunk.shape[0]
    n_lists, mls = list_ids.shape
    cd = cache.shape[-1]
    dsub = codebooks.shape[-1]
    safe = labels.to(torch.int64).clamp(max=n_lists - 1)
    resid = rotate_rows(chunk - centers[safe], rotation).reshape(m, pq_dim,
                                                                 dsub)
    packed = pack_codes(_encode(resid, codebooks), pq_bits)
    rec = _decode_code_rows(codebooks, packed, scale, pq_dim, pq_bits)[:, :cd]
    rf = rec.to(torch.float32) * scale
    b = 2.0 * (rc_t[safe] * rf).sum(1) + (rf * rf).sum(1)
    order, lst, pos = _chunk_positions(labels, base, n_lists, mls)
    cache[lst, pos] = rec[order]
    list_ids[lst, pos] = (row_start + order).to(torch.int32)
    b_sum[lst, pos] = b[order]


@traced("ivf_pq::build_streaming")
def build_streaming(chunk_fn: Callable[[int, int], Any], n: int, dim: int,
                    params: IvfPqParams = IvfPqParams(),
                    res: Optional[Resources] = None,
                    device: Optional[DeviceLike] = None,
                    chunk_rows: int = 0, train_rows: int = 0,
                    store: str = "codes", cache_dim: int = 0) -> IvfPqIndex:
    """Out-of-memory build: the dataset visits the device one chunk at a
    time. ``chunk_fn(start, end)`` returns rows ``start:end`` (numpy or a
    tensor, any device); it is called for a training sample and once per
    chunk in each of two passes, so it must be deterministic.

    * the quantizers train on ``train_rows`` rows (default ≤ 2M, a slice
      from every chunk);
    * pass 1 assigns each chunk; under the list cap a row whose nearest
      list is full goes to its second-nearest (:func:`_packing.
      assign_top2`, :func:`_packing.divert_to_cap`), and a row whose
      second choice is full too is dropped and counted
      (``index._streaming_dropped``; none at the auto cap);
    * pass 2 encodes each chunk and writes it at precomputed per-list
      offsets into the preallocated lists, in place;
    * ``store="codes"`` keeps packed codes (every backend searches them);
      ``store="cache"`` keeps only the int8 residual cache, truncated to
      the first ``cache_dim`` rotated coordinates (per-subspace codebooks
      only): such an index searches through the ragged backend and cannot
      be extended or saved.

    ``index.build_timings_s`` holds the seconds of training, pass 1 and
    pass 2."""
    res = resources_for(device, res)
    dev = res.device
    if params.metric == "cosine":
        raise ValueError("build_streaming: cosine needs normalized chunks; "
                         "normalize inside chunk_fn and use inner_product")
    if store not in ("codes", "cache"):
        raise ValueError(f"unknown store mode {store!r}")
    cluster = params.codebook_kind == "cluster"
    if store == "cache" and cluster:
        raise ValueError(
            "store='cache' supports subspace codebooks only (the truncated "
            "cache has no per-list codebook to decode against); use "
            "store='codes' for codebook_kind='cluster'")
    pq_dim = params.pq_dim or _auto_pq_dim(dim)
    if pq_dim > dim:
        raise ValueError(f"pq_dim={pq_dim} > dim={dim}")
    dsub = -(-dim // pq_dim)
    rot_dim = pq_dim * dsub
    cd = int(cache_dim) or rot_dim
    if not 0 < cd <= rot_dim:
        raise ValueError(f"cache_dim={cd} out of range (1..{rot_dim})")
    n_lists = params.n_lists
    n_codes = 1 << params.pq_bits
    km_metric = ("inner_product" if params.metric == "inner_product"
                 else "sqeuclidean")
    km = kmeans_balanced.KMeansBalancedParams(
        n_iters=params.kmeans_n_iters, metric=km_metric, seed=params.seed)
    chunk = int(chunk_rows) or int(
        max(262_144, min(n, res.workspace_bytes // max(dim * 12, 1))))
    chunk = min(chunk, n)
    starts = list(range(0, n, chunk))
    group = params.group_size or _packing.auto_group_size(n, n_lists,
                                                          floor=128)
    cap = params.list_size_cap
    if cap < 0:
        cap = _packing.auto_list_cap(n, n_lists, group)

    def rows_of(s, e):
        return torch.as_tensor(chunk_fn(s, e)).to(dev).to(torch.float32)

    t0 = time.perf_counter()
    t_rows = int(train_rows) or int(min(2_000_000, max(
        n_lists * 32, n * params.kmeans_trainset_fraction)))
    t_rows = min(t_rows, n)
    per = max(1, t_rows // len(starts))
    trainset = torch.cat([rows_of(s, min(s + per, n)) for s in starts], 0)
    centers = kmeans_balanced.fit(trainset, n_lists, km, res=res)
    _, g_rot, g_cb = kmeans_balanced.seeded_generators(params.seed, 3, dev)
    rotation = make_rotation_matrix(g_rot, rot_dim, dev)
    train_labels = kmeans_balanced.predict(trainset, centers, km, res=res)
    cb_rows = min(trainset.shape[0], 65536)
    resid = rotate_rows(trainset[:cb_rows] - centers[train_labels[:cb_rows]],
                        rotation).reshape(cb_rows, pq_dim, dsub)
    if cluster:
        codebooks = _train_codebooks_cluster(
            resid, train_labels[:cb_rows], g_cb, n_codes,
            params.codebook_n_iters, n_lists)
    else:
        codebooks = _train_codebooks(resid.transpose(0, 1).contiguous(), g_cb,
                                     n_codes, params.codebook_n_iters,
                                     res.workspace_bytes)
    del trainset, train_labels, resid
    _sync(dev)
    t1 = time.perf_counter()

    # pass 1: streamed assignment, diverted under the cap
    run = torch.zeros(n_lists, dtype=torch.int64, device=dev)
    counts = []
    labels_chunks = []
    for s in starts:
        check_interrupt()
        rows = rows_of(s, min(s + chunk, n))
        if cap:
            l1, l2 = _packing.assign_top2(rows, centers, metric=km_metric)
            labels = _packing.divert_to_cap(l1, l2, run, cap, n_lists)
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
    totals = counts_np.sum(axis=0)
    mls = _packing.round_list_size(int(totals.max()), group,
                                   pow2_chunks=group == 512)
    base_np = np.cumsum(counts_np, axis=0) - counts_np    # per-chunk offsets
    if dropped:
        _log.warning(
            "build_streaming: %d row(s) overflowed both their nearest and "
            "second-nearest capped lists and were dropped (cap=%d); raise "
            "list_size_cap or n_lists.", dropped, cap)
    _sync(dev)
    t2 = time.perf_counter()

    # pass 2: encode and write each chunk at its offsets
    list_ids = torch.full((n_lists, mls), -1, dtype=torch.int32, device=dev)
    decoded = scale = None
    if store == "cache":
        decoded = torch.zeros((n_lists, mls, cd), dtype=torch.int8, device=dev)
        b_sum = torch.full((n_lists, mls), float("inf"), device=dev)
        rc_t = rotate_rows(centers, rotation)[:, :cd]
        scale = torch.clamp(codebooks.abs().max(), min=1e-30) / 127.0
        for ci, s in enumerate(starts):
            check_interrupt()
            _scatter_chunk_cache(
                decoded, list_ids, b_sum, rows_of(s, min(s + chunk, n)),
                labels_chunks[ci], torch.from_numpy(base_np[ci]).to(dev), s,
                centers, rotation, codebooks, rc_t, scale, pq_dim,
                params.pq_bits)
        if params.metric == "inner_product":
            b_sum = torch.where(list_ids >= 0, 0.0, float("inf"))
        list_codes = torch.zeros((n_lists, mls, 0), dtype=torch.uint8,
                                 device=dev)
    else:
        list_codes = torch.zeros(
            (n_lists, mls, packed_width(pq_dim, params.pq_bits)),
            dtype=torch.uint8, device=dev)
        for ci, s in enumerate(starts):
            check_interrupt()
            _scatter_chunk(
                list_codes, list_ids, rows_of(s, min(s + chunk, n)),
                labels_chunks[ci], torch.from_numpy(base_np[ci]).to(dev), s,
                centers, rotation, codebooks, pq_dim, params.pq_bits, cluster)
        b_sum = _compute_b_sum(centers, rotation, codebooks, list_codes,
                               list_ids, params.metric, pq_dim,
                               params.pq_bits, cluster)
    _sync(dev)
    t3 = time.perf_counter()
    return IvfPqIndex(
        centers, rotation, codebooks, list_codes, list_ids, b_sum,
        params.metric, params.pq_bits, group, params.codebook_kind, pq_dim,
        decoded, scale, {"train": t1 - t0, "assign": t2 - t1,
                         "encode": t3 - t2}, dropped)


@traced("ivf_pq::extend")
def extend(index: IvfPqIndex, new_vectors, new_ids=None,
           res: Optional[Resources] = None,
           device: Optional[DeviceLike] = None) -> IvfPqIndex:
    """Encode new rows with the index's quantizers and repack → a new
    index. The build's granule is kept (legacy indexes infer it); new rows
    spill under the auto cap on top of each list's fill; ids default to
    ``max + 1 …``. A cache-only index raises ``ValueError``."""
    if index.cache_only:
        raise ValueError(
            "cache-only streamed index (build_streaming store='cache') "
            "keeps no codes and cannot extend(); rebuild with "
            "store='codes'")
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
    group = index.group_size or (512 if index.max_list_size % 512 == 0
                                 else 128)
    cap = _packing.auto_list_cap(index.size + X.shape[0], index.n_lists, group)
    # spill before encoding: residuals are taken against the assigned center
    labels = _packing.spill_to_cap(X, index.centers, labels, km_metric, cap,
                                   base_counts=index.list_sizes())
    cluster = index.codebook_kind == "cluster"
    dsub = index.codebooks.shape[2]
    resid = rotate_rows(X - index.centers[labels], index.rotation)
    codes = pack_codes(_encode_rows(resid.reshape(X.shape[0], index.pq_dim,
                                                  dsub),
                                    labels, index.codebooks, cluster),
                       index.pq_bits)
    old_codes, old_ids, old_labels = _packing.unpack_lists(index.list_codes,
                                                           index.list_ids)
    if old_codes.shape[-1] != packed_width(index.pq_dim, index.pq_bits):
        # legacy index with one byte per subspace: repack to the new width
        old_codes = pack_codes(old_codes, index.pq_bits)
    if new_ids is None:
        start = int(old_ids.max()) + 1 if old_ids.numel() else 0
        new_ids = torch.arange(start, start + X.shape[0], dtype=torch.int32,
                               device=X.device)
    else:
        new_ids = torch.as_tensor(new_ids).to(X.device, torch.int32)
    list_codes, list_ids = _packing.pack_lists(
        torch.cat([old_codes, codes]), torch.cat([old_ids, new_ids]),
        torch.cat([old_labels.to(torch.int64), labels.to(torch.int64)]),
        index.n_lists, group, pow2_chunks=group == 512)
    b_sum = _compute_b_sum(index.centers, index.rotation, index.codebooks,
                           list_codes, list_ids, index.metric, index.pq_dim,
                           index.pq_bits, cluster)
    return IvfPqIndex(index.centers, index.rotation, index.codebooks,
                      list_codes, list_ids, b_sum, index.metric,
                      index.pq_bits, group, index.codebook_kind, index.pq_dim)


def reconstruct_rows(centers, rotation, codebooks, codes, labels,
                     pq_dim: int, pq_bits: int,
                     dim: Optional[int] = None) -> torch.Tensor:
    """Approximate input vectors from packed codes (per-subspace
    codebooks): each subspace's exact fp32 codeword (not the int8 cache),
    un-rotated and re-centered on the row's list center. Re-encoding the
    result against the same centers gives back the codes."""
    n_codes, dsub = codebooks.shape[1], codebooks.shape[2]
    cb_flat = codebooks.reshape(pq_dim * n_codes, dsub)
    s_off = torch.arange(pq_dim, device=codebooks.device) * n_codes
    cv = _codes_view(codes, pq_dim, pq_bits).to(torch.int64)
    resid = unrotate_rows(cb_flat[cv + s_off].reshape(codes.shape[0],
                                                      pq_dim * dsub), rotation)
    d = centers.shape[1] if dim is None else int(dim)
    return centers[labels.to(torch.int64)] + resid[:, :d]


# ---------------------------------------------------------------------------
# Search (the "ragged" strip backend)
# ---------------------------------------------------------------------------


def _row_b_sum(centers, rotation, codebooks, codes, labels, pq_dim: int,
               pq_bits: int):
    """The list-side LUT half of freshly encoded rows (n,): the table and
    Σ_s reduction of :func:`_compute_b_sum`, gathered by each row's label,
    so a paged store's aux equals the packed build's bit for bit."""
    n_codes = codebooks.shape[1]
    B = _b_table(centers, rotation, codebooks, pq_dim)
    s_off = torch.arange(pq_dim, device=centers.device) * n_codes
    idx = _codes_view(codes, pq_dim, pq_bits).to(torch.int64) + s_off
    return torch.gather(B[labels.to(torch.int64)], 1, idx).sum(-1)


def _center_rot_sqnorm(centers, rotation) -> torch.Tensor:
    """‖R·c̃_l‖² per list: the per-list constant of the decoded-cache scan
    bias, shared by the packed scan and the paged store."""
    return sqnorm(rotate_rows(centers, rotation))


def _decode_code_rows(codebooks, codes, scale, pq_dim: int, pq_bits: int):
    """int8 decoded residual rows (n, rot_dim) of freshly encoded codes: the
    quantized codebook and flat gather of :func:`_decode_lists_scaled`, row
    by row, so a paged store's cache rows equal the packed decode's."""
    n_codes, dsub = codebooks.shape[1], codebooks.shape[2]
    cb_q = torch.clamp(torch.round(codebooks / scale), -127, 127).to(torch.int8)
    cb_flat = cb_q.reshape(pq_dim * n_codes, dsub)
    s_off = torch.arange(pq_dim, device=codebooks.device) * n_codes
    cv = _codes_view(codes, pq_dim, pq_bits).to(torch.int64)
    return cb_flat[cv + s_off].reshape(codes.shape[0], pq_dim * dsub)


def _ragged_bias_pq(b_sum, centers, rotation, l2: bool):
    """Per-entry scan bias: ‖R·c_l‖² + b_sum for L2, b_sum (0/+inf) for
    inner-product metrics."""
    if not l2:
        return b_sum
    return _center_rot_sqnorm(centers, rotation)[:, None] + b_sum


def _pq_probe_prep(queries, centers, rotation, n_probes: int,
                   select_algo: str, l2: bool, rotation_kind: str = "dense"):
    """Probe selection (exact fp32 coarse distances), the rotated queries
    and the exact per-pair center term ``alpha·⟨q, c_l⟩``. IVF-BQ shares
    it; ``rotation_kind`` picks the dense gemm or the SRHT butterfly."""
    ip_c = matmul_t(queries, centers)
    if l2:
        coarse = sqnorm(queries)[:, None] + sqnorm(centers)[None, :] - 2.0 * ip_c
    else:
        coarse = -ip_c
    _, probes = select_k(coarse, n_probes, select_min=True, algo=select_algo)
    qr = rotate_rows(queries, rotation, rotation_kind)
    alpha = -2.0 if l2 else -1.0
    pair_const = alpha * torch.gather(ip_c, 1, probes.to(torch.int64))
    return probes, qr, pair_const


def _pq_search_prep(queries, centers, rotation, b_sum, decoded_scale,
                    n_probes: int, select_algo: str, l2: bool,
                    list_ids=None, filter=None):
    with obs.record_span("ivf_pq::probe_select"):
        probes, qr, pair_const = _pq_probe_prep(queries, centers, rotation,
                                                n_probes, select_algo, l2)
    with obs.record_span("ivf_pq::bias"):
        bias = _filtering.apply_filter_bias(
            _ragged_bias_pq(b_sum, centers, rotation, l2), list_ids, filter)
    return probes, qr * decoded_scale, bias, pair_const


def _ragged_fused_pq(queries, index: IvfPqIndex, k: int, n_probes: int,
                     select_algo: str, l2: bool, classes, class_counts,
                     cls_ord, q_tile: int, filter=None):
    """Prep, device plan, int8 strip scan (tournament allowed: the path
    over-fetches and re-ranks exactly; under a filter K1's gathered walk)
    and finalize. A cache truncated to its first ``cache_dim`` rotated
    coordinates (``build_streaming(store="cache")``) takes the query
    operand's same leading coordinates; its b_sum was built in the
    truncated space and the center terms stay exact."""
    obs_compile.trace_event(
        "ivf_pq.search_ragged", queries=queries, centers=index.centers,
        rotation=index.rotation, b_sum=index.b_sum, list_ids=index.list_ids,
        decoded=index.decoded, decoded_scale=index.decoded_scale,
        filter=filter, cls_ord=cls_ord,
        static={"k": k, "n_probes": n_probes, "metric": index.metric,
                "select_algo": select_algo, "l2": l2, "classes": classes,
                "class_counts": class_counts, "q_tile": q_tile})
    probes, qr_scaled, bias, pair_const = _pq_search_prep(
        queries, index.centers, index.rotation, index.b_sum,
        index.decoded_scale, n_probes, select_algo, l2, index.list_ids,
        filter)
    qr_scaled = qr_scaled[:, :index.decoded.shape[-1]]
    vals, ids = strip_scan.strip_search_traced(
        qr_scaled, probes, index.decoded, bias, index.list_ids, cls_ord,
        classes, class_counts, int(k), int(k), -2.0 if l2 else -1.0,
        q_tile, pair_const=pair_const, approx_ok=True,
        gathered=filter is not None)
    with obs.record_span("ivf_pq::finalize"):
        return _finalize_ragged(vals, ids, queries, index.metric)


def _search_ragged_pq(index: IvfPqIndex, queries, k: int, n_probes: int,
                      select_algo: str, res: Resources, filter=None):
    if index.decoded is None:
        index.decoded, index.decoded_scale = _decode_lists(
            index.codebooks, index.list_codes, index.pq_dim, index.pq_bits,
            index.codebook_kind == "cluster")
    l2 = index.metric in ("sqeuclidean", "euclidean")
    classes, class_counts, cls_ord, q_tile = _ragged_plan_static(
        index, n_probes, k, res, int(index.decoded.shape[-1]))
    return _ragged_fused_pq(queries, index, int(k), n_probes, select_algo, l2,
                            classes, class_counts, cls_ord,
                            min(q_tile, queries.shape[0]), filter)


# ---------------------------------------------------------------------------
# Search (the LUT backends: "pallas" through K5, "gather" in plain torch)
# ---------------------------------------------------------------------------


def _query_luts(queries, rotation, codebooks, metric: str,
                lut_dtype: torch.dtype) -> torch.Tensor:
    """Per-query LUT (q, pq_dim, n_codes): ``−2⟨(Rq)_s, cb[s, c]⟩`` for L2,
    ``−⟨·,·⟩`` for inner-product metrics, one fp32 einsum, then cast to
    ``lut_dtype`` (bf16 for the K5 scan, fp32 for gather)."""
    pq_dim, _, dsub = codebooks.shape
    rq = rotate_rows(queries, rotation).reshape(queries.shape[0], pq_dim, dsub)
    A = torch.einsum("qsd,scd->qsc", rq, codebooks)
    A = (-2.0 if metric in ("sqeuclidean", "euclidean") else -1.0) * A
    return A.to(lut_dtype)


def _coarse_select(queries, centers, n_probes: int, select_algo: str,
                   l2: bool, compute_dtype):
    """Stage 1 of the LUT backends: (probed coarse values, probes). The
    values are the pair constant, ‖q − c‖² for L2 and −⟨q, c⟩ else."""
    if l2:
        coarse = expanded_sqeuclidean(queries, centers, compute_dtype)
    else:
        coarse = -matmul_t(queries, centers, compute_dtype)
    return select_k(coarse, n_probes, select_min=True, algo=select_algo)


def _finish_lut(vals, ids, metric: str):
    """LUT-backend scores → distances: clamp and sqrt for L2, the raw inner
    product back for the others."""
    if metric in ("sqeuclidean", "euclidean"):
        vals = torch.clamp(vals, min=0.0)
        return torch.sqrt(vals) if metric == "euclidean" else vals
    return -vals


def _pallas_prep(queries, index: IvfPqIndex, n_probes: int,
                 select_algo: str, compute_dtype):
    """What every query tile of the pallas backend shares: the coarse
    select, the flat bf16 LUTs (q, pq_dim·n_codes) and the codes
    transposed list-minor (n_lists, pq_dim, m) for K5."""
    l2 = index.metric in ("sqeuclidean", "euclidean")
    coarse_vals, probes = _coarse_select(queries, index.centers, n_probes,
                                         select_algo, l2, compute_dtype)
    luts = _query_luts(queries, index.rotation, index.codebooks, index.metric,
                       torch.bfloat16).reshape(queries.shape[0], -1)
    codes_t = _codes_view(index.list_codes, index.pq_dim,
                          index.pq_bits).transpose(1, 2).contiguous()
    return coarse_vals, probes, luts, codes_t


def _pallas_pairs(probe_blk):
    """One query tile's probed pairs sorted by list, stably (the order of
    :func:`pq_scan.group_probed_pairs`) → (pair_lut, pair_list, pair_out)
    int32: each pair's query (its LUT row in the tile), its list, and its
    row ``query·p + probe_rank`` of the tile's (qt·p, m) scores."""
    p = probe_blk.shape[1]
    flat = probe_blk.reshape(-1).to(torch.int64)
    order = torch.argsort(flat, stable=True)
    return (torch.div(order, p, rounding_mode="floor").to(torch.int32),
            flat[order].to(torch.int32), order.to(torch.int32))


def _pallas_tile(luts_t, probe_blk, cvals_blk, codes_t, index: IvfPqIndex,
                 k: int, select_algo: str, filter=None):
    """One query tile: its pairs through K5 (scores in query/probe order,
    +inf at padding entries), the pair constant added, entries whose id
    fails ``filter`` set to +inf, the top-k over p·m and the winners' ids
    → (scores, ids, pairs sorted by list)."""
    qt, p = probe_blk.shape
    m = index.max_list_size
    pair_lut, pair_list, pair_out = _pallas_pairs(probe_blk)
    scores = pq_scan.pq_scan_pairs(luts_t, pair_lut, pair_list, pair_out,
                                   codes_t, index.b_sum, index.n_codes)
    d = scores.reshape(qt, p, m) + cvals_blk[:, :, None]
    del scores
    pb = probe_blk.to(torch.int64)
    if filter is not None:
        d = torch.where(filter.test(index.list_ids[pb]), d, float("inf"))
    vals, sel = select_k(d.reshape(qt, -1), k, select_min=True,
                         algo=select_algo)
    sel = sel.to(torch.int64)
    ids = index.list_ids[torch.gather(pb, 1, sel // m), sel % m]
    ids = torch.where(torch.isinf(vals), -1, ids)
    return vals, ids, pair_list


def pallas_q_tile(q: int, n_probes: int, max_list_size: int, lut_row_bytes: int,
                  workspace_bytes: int) -> int:
    """Query tile of the pallas backend: the (qt·p, m) fp32 scores plus the
    tile's LUT table within the workspace. The largest such tile is the
    fastest: more pairs a list a tile fill K5's 16-pair blocks, and fewer
    tiles mean fewer launches and selects."""
    per_query = n_probes * max_list_size * 4 + lut_row_bytes
    return int(max(1, min(q, workspace_bytes // per_query)))


def _search_pallas(index: IvfPqIndex, queries, k: int, n_probes: int,
                   select_algo: str, res: Resources,
                   stats: Optional[dict] = None, filter=None):
    """The pallas backend: shared prep, then every query tile's probed
    pairs through K5 (:func:`_pallas_tile`) in one pass. No pair is
    dropped, so the result is the JAX package's final attempt at a cap no
    list exceeds; ``stats`` gets the tiles, the largest per-list load of
    each tile (``max_list_load``; ``qpl_cap`` is their maximum) and one
    attempt with 0 dropped (K5 launches = tiles)."""
    if index.max_list_size % 128:
        raise ValueError(
            f"pallas backend needs max_list_size % 128 == 0, got "
            f"{index.max_list_size}; rebuild with group_size=128 "
            "(or use backend='gather')")
    q = queries.shape[0]
    q_tile = pallas_q_tile(q, n_probes, index.max_list_size,
                           index.pq_dim * index.n_codes * 2,
                           res.workspace_bytes)
    obs_compile.trace_event(
        "ivf_pq.search_pallas", queries=queries, centers=index.centers,
        rotation=index.rotation, codebooks=index.codebooks,
        list_codes=index.list_codes, list_ids=index.list_ids,
        b_sum=index.b_sum, filter=filter,
        static={"k": k, "n_probes": n_probes, "metric": index.metric,
                "q_tile": q_tile, "select_algo": select_algo,
                "compute_dtype": res.compute_dtype, "pq_dim": index.pq_dim,
                "pq_bits": index.pq_bits})
    coarse_vals, probes, luts, codes_t = _pallas_prep(
        queries, index, n_probes, select_algo, res.compute_dtype)
    outs, loads = [], []
    for s in range(0, q, q_tile):
        v, i, pair_list = _pallas_tile(
            luts[s:s + q_tile], probes[s:s + q_tile],
            coarse_vals[s:s + q_tile], codes_t, index, k, select_algo,
            filter)
        outs.append((v, i))
        if stats is not None:
            loads.append(torch.bincount(pair_list.to(torch.int64)).max())
    vals = torch.cat([v for v, _ in outs])
    ids = torch.cat([i for _, i in outs])
    if stats is not None:
        loads = torch.stack(loads).tolist()
        stats.update(q_tile=q_tile, tiles=len(loads), max_list_load=loads,
                     qpl_cap=max(loads),
                     attempts=[{"qpl_cap": max(loads), "dropped": 0}])
    return _finish_lut(vals, ids, index.metric), ids


def _search_impl_jnp(queries, centers, rotation, codebooks, metric: str,
                     pq_dim: int, pq_bits: int, cluster: bool, k: int,
                     n_probes: int, q_tile: int, select_algo: str,
                     compute_dtype, gather, filter=None):
    """Gather-backend search (the JAX package's ``_search_impl_jnp`` and
    paged ``_paged_impl``): coarse select, fp32 per-query LUTs (per probed
    pair for per-cluster codebooks) and a code lookup with plain tensor
    ops, per query tile. ``gather(probes)`` → (packed codes (qt, p, M, ·),
    ids (qt, p, M), b_sum (qt, p, M)) of the probed lists' M slots; ids
    that are -1 or fail ``filter`` are masked."""
    q = queries.shape[0]
    l2 = metric in ("sqeuclidean", "euclidean")
    n_codes, dsub = codebooks.shape[-2], codebooks.shape[-1]
    coarse_vals, probes = _coarse_select(queries, centers, n_probes,
                                         select_algo, l2, compute_dtype)
    if cluster:       # the LUT varies by list: keep the rotated queries
        luts = rotate_rows(queries, rotation).reshape(q, pq_dim, dsub)
    else:
        luts = _query_luts(queries, rotation, codebooks, metric,
                           torch.float32).reshape(q, -1)
    s_off = torch.arange(pq_dim, device=queries.device) * n_codes
    outs = []
    for s in range(0, q, q_tile):
        pb = probes[s:s + q_tile].to(torch.int64)
        qt, p = pb.shape
        codes, ids, b = gather(pb)
        m = codes.shape[2]
        idx = _codes_view(codes, pq_dim, pq_bits).to(torch.int64) + s_off
        if cluster:
            A = torch.einsum("qsd,qpcd->qpsc", luts[s:s + q_tile],
                             codebooks[pb])
            A = ((-2.0 if l2 else -1.0) * A).reshape(qt * p, pq_dim * n_codes)
            picked = torch.gather(A, 1, idx.reshape(qt * p, m * pq_dim))
        else:
            picked = torch.gather(luts[s:s + q_tile], 1, idx.reshape(qt, -1))
        d = (picked.reshape(qt, p, m, pq_dim).sum(3) + b
             + coarse_vals[s:s + q_tile, :, None])
        if l2:
            d = torch.clamp(d, min=0.0)
            if metric == "euclidean":
                d = torch.sqrt(d)
        flat_ids = ids.reshape(qt, -1)
        valid = flat_ids >= 0
        if filter is not None:
            valid = valid & filter.test(flat_ids)
        d = torch.where(valid, d.reshape(qt, -1), float("inf"))
        vals, sel = select_k(d, k, select_min=True, algo=select_algo)
        out_ids = torch.gather(flat_ids, 1, sel.to(torch.int64))
        outs.append((vals, torch.where(torch.isinf(vals), -1, out_ids)))
    vals = torch.cat([v for v, _ in outs])
    return (vals if l2 else -vals), torch.cat([i for _, i in outs])


def _gather_q_tile(q: int, n_probes: int, cols: int, pq_dim: int,
                   workspace_bytes: int) -> int:
    """Query tile of the gather backends: the (qt, p, cols, pq_dim) code
    gather dominates."""
    per_query = max(1, n_probes * cols * (pq_dim * 5 + 8))
    return int(max(1, min(q, workspace_bytes // per_query)))


def resolve_backend(backend: str, device_type: str, max_list_size: int,
                    k: int, codebook_kind: str = "subspace",
                    cache_only: bool = False) -> str:
    """The backend :func:`search` runs for an index on ``device_type``:

    * ``"auto"`` on ``cuda``: ``"ragged"`` (K1 over the int8 cache) when
      ``max_list_size`` is a power-of-two multiple of 512 and k ≤ 512, else
      ``"pallas"`` (K5) when it is a multiple of 128 and the codebooks are
      per subspace, else ``"gather"``; on the CPU, ``"gather"``;
    * a cache-only index has only the cache: ``"ragged"``, and
      ``ValueError`` when that is ineligible or another backend is named;
    * ``"pallas"`` on per-cluster codebooks raises ``ValueError`` (K5's
      table is per query, theirs is per list): nothing is rerouted."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of "
                         f"{BACKENDS})")
    aligned = strip_scan.strip_eligible(max_list_size) and k <= 512
    if cache_only:
        if backend not in ("auto", "ragged"):
            raise ValueError(f"a cache-only streamed index keeps no codes "
                             f"for backend {backend!r}; it searches through "
                             "'ragged'")
        if not aligned:
            raise ValueError(
                "cache-only streamed index needs a strip-eligible "
                f"max_list_size (power-of-two multiple of 512 and k <= 512), "
                f"got {max_list_size} / k={k}")
        return "ragged"
    cluster = codebook_kind == "cluster"
    if backend == "auto":
        if device_type != "cuda":
            return "gather"
        if aligned:
            return "ragged"
        return "pallas" if max_list_size % 128 == 0 and not cluster \
            else "gather"
    if backend == "pallas" and cluster:
        raise ValueError("backend='pallas' scans per-query LUTs, and "
                         "per-cluster codebooks need one per list; use "
                         "backend='ragged' or 'gather' (or 'auto')")
    return backend


@traced("ivf_pq::search")
def search(index: IvfPqIndex, queries, k: int, n_probes: int = 20,
           filter=None, select_algo: str = "exact", backend: str = "auto",
           res: Optional[Resources] = None,
           device: Optional[DeviceLike] = None,
           stats: Optional[dict] = None):
    """Approximate k-NN over the PQ lists → (distances (q, k) fp32, ids
    (q, k) int32). Distances are PQ approximations: re-rank with
    :func:`raft_tpu_torch.neighbors.refine.refine`. ``backend``: "auto",
    "ragged", "pallas" or "gather" (:func:`resolve_backend`). ``stats``, a
    dict, receives the backend and, for "pallas", the query tile, tiles,
    each tile's largest per-list load and its one attempt (K5 launches =
    tiles). ``filter``: a :class:`~raft_tpu_torch.core.bitset.Bitset` over
    source ids; rows whose id fails never come back, and n_probes widens
    by its selectivity."""
    res = resources_for(device, res)
    if index.device != res.device:
        raise ValueError(f"index lives on {index.device}, search runs on "
                         f"{res.device}; move it with index.to(device)")
    queries = torch.as_tensor(queries).to(device=res.device, dtype=torch.float32)
    if queries.ndim != 2 or queries.shape[1] != index.dim:
        raise ValueError(f"queries must be (q, {index.dim}), got {tuple(queries.shape)}")
    n_probes = int(min(n_probes, index.n_lists))
    n_probes, filter_attrs = _filter_plan("ivf_pq.search.filter", filter,
                                          n_probes, index.n_lists)
    if not 0 < k <= n_probes * index.max_list_size:
        raise ValueError(f"k={k} out of range")
    backend = resolve_backend(backend, res.device.type, index.max_list_size,
                              int(k), index.codebook_kind, index.cache_only)
    if stats is not None:
        stats["backend"] = backend
    if index.metric == "cosine":
        queries = queries / torch.clamp(
            torch.linalg.vector_norm(queries, dim=1, keepdim=True), min=1e-30)
    scan_attrs = None
    if obs.enabled():
        q = int(queries.shape[0])
        scan_attrs = _scan_telemetry("ivf_pq.search", backend, q, n_probes,
                                     k, filter_attrs)
        # the dispatch's static FLOP/byte model, with the strip planner's
        # occupancy when the host already holds the list lengths
        rot_dim_obs = int(index.rotation.shape[0])
        occ = None
        lens_cached = getattr(index, "_lens_np_cache", None)
        if backend == "ragged" and lens_cached is not None \
                and lens_cached.shape[0] == index.n_lists:
            kf_occ = min(int(k), 512)
            occ = obs_roofline.memo_occupancy(
                index,
                (id(lens_cached), q, int(n_probes), kf_occ,
                 res.workspace_bytes),
                lambda: strip_scan.occupancy_stats(
                    lens_cached, index.max_list_size, q, n_probes,
                    dim=rot_dim_obs, workspace_bytes=res.workspace_bytes,
                    kf=kf_occ))
        obs_roofline.note_dispatch(
            "ivf_pq.search",
            {"q": q, "dim": index.dim, "n_lists": index.n_lists,
             "max_list_size": index.max_list_size,
             "pq_dim": index.pq_dim, "pq_bits": index.pq_bits,
             "n_probes": int(n_probes), "k": int(k),
             "rot_dim": rot_dim_obs},
            occupancy=occ)
    faultpoint("ivf_pq.search.scan")
    with obs.record_span("ivf_pq::scan", attrs=scan_attrs), \
            obs_compile.watch():
        return _search_backend(index, queries, int(k), n_probes, filter,
                               select_algo, backend, res, stats)


def _search_backend(index: IvfPqIndex, queries, k: int, n_probes: int,
                    filter, select_algo: str, backend: str, res: Resources,
                    stats: Optional[dict]):
    """The scan of :func:`search` through the resolved backend."""
    if backend == "ragged":
        if not (strip_scan.strip_eligible(index.max_list_size) and k <= 512):
            raise ValueError(
                f"ragged backend needs max_list_size = a power-of-two "
                f"multiple of 512 and k <= 512, got {index.max_list_size} / "
                f"k={k}; rebuild with group_size=512 (or use "
                "backend='pallas'/'gather')")
        return _search_ragged_pq(index, queries, int(k), n_probes,
                                 select_algo, res, filter)
    if backend == "pallas":
        vals, ids = _search_pallas(index, queries, int(k), n_probes,
                                   select_algo, res, stats, filter)
    else:
        q_tile = _gather_q_tile(queries.shape[0], n_probes,
                                index.max_list_size, index.pq_dim,
                                res.workspace_bytes)
        obs_compile.trace_event(
            "ivf_pq.search", queries=queries, centers=index.centers,
            rotation=index.rotation, codebooks=index.codebooks,
            list_codes=index.list_codes, list_ids=index.list_ids,
            b_sum=index.b_sum, filter=filter,
            static={"k": k, "n_probes": n_probes, "metric": index.metric,
                    "q_tile": q_tile, "select_algo": select_algo,
                    "compute_dtype": res.compute_dtype,
                    "pq_dim": index.pq_dim, "pq_bits": index.pq_bits,
                    "cluster": index.codebook_kind == "cluster"})
        vals, ids = _search_impl_jnp(
            queries, index.centers, index.rotation, index.codebooks,
            index.metric, index.pq_dim, index.pq_bits,
            index.codebook_kind == "cluster", int(k), n_probes, q_tile,
            select_algo, res.compute_dtype,
            lambda pb: (index.list_codes[pb], index.list_ids[pb],
                        index.b_sum[pb]), filter)
    if index.metric == "cosine":
        vals = torch.where(ids >= 0, 1.0 - vals, float("inf"))
    return vals, ids


# ---------------------------------------------------------------------------
# Paged search (serving): K3 over a PagedListStore's int8 cache pool
# ---------------------------------------------------------------------------


def _paged_fused_pq(queries, store, cache_pool, bias_pool, page_ids, table,
                    chain_pages, k: int, n_probes: int, select_algo: str,
                    q_tile: int):
    """The packed path's probe prep (probes, rotated queries, the exact
    −2⟨q, c_l⟩ pair term), K3 over the cache pool in place with the
    store's bias pool (already ‖R·c_l‖² + b_sum per row), merge and
    finalize. No tournament: the paged scan runs the exact carry."""
    obs_compile.trace_event(
        "ivf_pq.paged_pallas", queries=queries, centers=store.centers,
        rotation=store.rotation, cache_pool=cache_pool, bias_pool=bias_pool,
        page_ids=page_ids, table=table, chain_pages=chain_pages,
        decoded_scale=store.decoded_scale,
        static={"k": k, "n_probes": n_probes, "metric": store.metric,
                "select_algo": select_algo, "q_tile": q_tile})
    l2 = store.metric in ("sqeuclidean", "euclidean")
    probes, qr, pair_const = _pq_probe_prep(
        queries, store.centers, store.rotation, n_probes, select_algo, l2)
    vals, ids = strip_scan.paged_strip_search_traced(
        qr * store.decoded_scale, probes, cache_pool, bias_pool, page_ids,
        table, chain_pages, int(k), int(k), -2.0 if l2 else -1.0, q_tile,
        pair_const=pair_const)
    return _finalize_ragged(vals, ids, queries, store.metric)


@traced("ivf_pq::search_paged")
def search_paged(store, queries, k: int, n_probes: int = 20, filter=None,
                 select_algo: str = "exact", backend: str = "auto",
                 res: Optional[Resources] = None,
                 device: Optional[DeviceLike] = None):
    """Approximate k-NN over a mutable paged code store (``PagedListStore``
    of kind ``"ivf_pq"``): :func:`search`'s contract while rows stream in
    and out. ``backend``: "paged" (K3 over the int8 cache pool), "gather"
    (the gather backend's fp32 lookup over the page table's codes, plain
    torch, any k) or "auto" (:func:`ivf_flat.paged_backend_auto`).
    ``filter`` (else the store's standing one) masks source ids. Re-rank
    with :func:`raft_tpu_torch.neighbors.refine.refine`."""
    res, n_probes, queries, filter, backend, filter_attrs = \
        _paged_search_args(store, "ivf_pq", queries, k, n_probes, filter,
                           backend, res, device)
    with _paged_scan_span(store, backend, int(queries.shape[0]), n_probes, k,
                          filter_attrs, res):
        return _search_paged_backend(store, queries, int(k), n_probes,
                                     filter, select_algo, backend, res)


def _search_paged_backend(store, queries, k: int, n_probes: int, filter,
                          select_algo: str, backend: str, res: Resources):
    """The scan of :func:`search_paged` through the resolved backend."""
    if backend == "gather":
        pages, page_ids, page_aux, table = store.scan_state()
        cols = table.shape[1] * store.page_rows
        q_tile = _gather_q_tile(queries.shape[0], n_probes, cols,
                                store.pq_dim, res.workspace_bytes)
        obs_compile.trace_event(
            "ivf_pq.paged_scan", queries=queries, centers=store.centers,
            rotation=store.rotation, codebooks=store.codebooks, pages=pages,
            page_ids=page_ids, page_aux=page_aux, table=table,
            filter=filter,
            static={"k": int(k), "n_probes": n_probes,
                    "metric": store.metric, "q_tile": q_tile,
                    "select_algo": select_algo,
                    "compute_dtype": res.compute_dtype,
                    "pq_dim": store.pq_dim, "pq_bits": store.pq_bits})
        vals, ids = _search_impl_jnp(
            queries, store.centers, store.rotation, store.codebooks,
            store.metric, store.pq_dim, store.pq_bits, False, int(k),
            n_probes, q_tile, select_algo, res.compute_dtype,
            _page_gather(table, page_ids, pages, page_aux), filter)
        if store.metric == "cosine":
            vals = torch.where(ids >= 0, 1.0 - vals, float("inf"))
        return vals, ids
    cache_pool, bias_pool, _, page_ids, table, chain_pages = \
        store.paged_scan_state()
    bias_pool = _filtering.apply_filter_bias(bias_pool, page_ids, filter)
    q_tile = min(_paged_plan_static(store, n_probes, k, res,
                                    store._cache_dim), queries.shape[0])
    return _paged_fused_pq(queries, store, cache_pool, bias_pool, page_ids,
                           table, chain_pages, int(k), n_probes, select_algo,
                           q_tile)
