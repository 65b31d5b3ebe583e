"""IVF-PQ: inverted lists of product-quantized residuals (counterpart of
``raft_tpu/neighbors/ivf_pq.py``).

The score algebra is the JAX package's, for L2:

    d²(q, x ∈ list l) = ‖q‖² − 2⟨q, c_l⟩ − 2⟨Rq, r̂⟩ + ‖R·c_l + r̂‖²

with ``r̂`` the decoded residual in rotated space. Search scans an int8
cache of ``r̂`` (``_decode_lists``) through the strip kernel with the
query operand ``Rq·scale``; ``‖R·c_l + r̂‖²`` is the per-entry bias
(``‖R·c_l‖² + b_sum``), the exact ``−2⟨q, c_l⟩`` pair term is added at the
merge, and ``‖q‖²`` at the end. Candidates are meant for exact re-ranking
(:mod:`raft_tpu_torch.neighbors.refine`).

This port has the per-subspace codebooks, the ``"ragged"`` strip backend
and the paged search over a ``PagedListStore`` (kernel K3 over the store's
int8 cache pool, :func:`search_paged`). The LUT and gather backends,
per-cluster codebooks, filters, streamed builds and cache-only indexes
come with later slices and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.core.serialize import load_arrays, save_arrays
from raft_tpu_torch.neighbors import _packing
from raft_tpu_torch.neighbors.ivf_flat import (_finalize_ragged,
                                               _paged_plan_static,
                                               _paged_search_args,
                                               _ragged_plan_static)
from raft_tpu_torch.ops import strip_scan
from raft_tpu_torch.ops.distance import canonical_metric, matmul_t, sqnorm
from raft_tpu_torch.ops.linalg import make_rotation_matrix, rotate_rows
from raft_tpu_torch.ops.select_k import select_k

SUPPORTED_METRICS = ("sqeuclidean", "euclidean", "inner_product", "cosine")
_LATER = "arrives with a later slice of the PyTorch port"


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
    """Coarse centers, rotation, per-subspace codebooks and packed code
    lists; ``list_ids == -1`` marks padding, ``b_sum`` is +inf there."""

    centers: torch.Tensor      # (n_lists, dim) fp32
    rotation: torch.Tensor     # (rot_dim, rot_dim) fp32, orthogonal
    codebooks: torch.Tensor    # (pq_dim, n_codes, dsub) fp32
    list_codes: torch.Tensor   # (n_lists, m, packed_width) uint8
    list_ids: torch.Tensor     # (n_lists, m) int32
    b_sum: torch.Tensor        # (n_lists, m) fp32
    metric: str = "sqeuclidean"
    pq_bits: int = 8
    group_size: int = 0
    codebook_kind: str = "subspace"
    pq_dim_hint: int = 0
    # int8 residual cache (n_lists, m, rot_dim) and its fp32 scale; derived
    # data, filled at the first search and never serialized
    decoded: Optional[torch.Tensor] = None
    decoded_scale: Optional[torch.Tensor] = None
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
    def max_list_size(self) -> int:
        return self.list_codes.shape[1]

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
        return IvfPqIndex(
            self.centers.to(dev), self.rotation.to(dev),
            self.codebooks.to(dev), self.list_codes.to(dev),
            self.list_ids.to(dev), self.b_sum.to(dev), self.metric,
            self.pq_bits, self.group_size, self.codebook_kind,
            self.pq_dim_hint)

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
        """Write the v2 container both packages read."""
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
    anything ``np.asarray`` takes) and its container meta. The int8 search
    cache is rebuilt from the codes at the first search."""
    if meta.get("kind", "ivf_pq") != "ivf_pq":
        raise ValueError(f"not an ivf_pq index: {meta.get('kind')}")
    dev = resources_for(device, res).device

    def t(name):
        return torch.from_numpy(np.array(arrays[name])).to(dev)

    return IvfPqIndex(
        t("centers"), t("rotation"), t("codebooks"), t("list_codes"),
        t("list_ids"), t("b_sum"), meta.get("metric", "sqeuclidean"),
        int(meta.get("pq_bits", 8)), int(meta.get("group_size", 0)),
        meta.get("codebook_kind", "subspace"),
        int(meta.get("pq_dim_hint", 0)))


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


def _list_chunks(n_lists: int, per_list: int, budget: int = 256 << 20):
    step = max(1, budget // max(1, per_list))
    return [(s, min(n_lists, s + step)) for s in range(0, n_lists, step)]


def _decode_lists(codebooks: torch.Tensor, list_codes: torch.Tensor,
                  pq_dim: int, pq_bits: int):
    """The int8 residual cache: per entry the codebook rows of its codes,
    quantized at scale max|codebooks|/127 → (cache (n_lists, m, rot_dim)
    int8, 0-d fp32 scale)."""
    scale = torch.clamp(codebooks.abs().max(), min=1e-30) / 127.0
    return _decode_lists_scaled(codebooks, list_codes, scale, pq_dim,
                                pq_bits), scale


def _decode_lists_scaled(codebooks, list_codes, scale, pq_dim: int,
                         pq_bits: int):
    n_lists, m = list_codes.shape[0], list_codes.shape[1]
    _, n_codes, dsub = codebooks.shape
    rot_dim = pq_dim * dsub
    cb_q = torch.clamp(torch.round(codebooks / scale), -127, 127).to(torch.int8)
    cb_flat = cb_q.reshape(pq_dim * n_codes, dsub)
    s_off = torch.arange(pq_dim, device=codebooks.device) * n_codes
    out = torch.empty((n_lists, m, rot_dim), dtype=torch.int8,
                      device=codebooks.device)
    for a, b in _list_chunks(n_lists, m * pq_dim * 8):
        codes = _codes_view(list_codes[a:b], pq_dim, pq_bits).to(torch.int64)
        out[a:b] = cb_flat[codes + s_off].reshape(b - a, m, rot_dim)
    return out


def _b_table(centers, rotation, codebooks, pq_dim: int) -> torch.Tensor:
    """(n_lists, pq_dim·n_codes) list-side LUT half: entry (l, s·n_codes +
    c) is 2·(R·c_l)_s·cb[s, c] + ‖cb[s, c]‖²."""
    n_lists = centers.shape[0]
    dsub = codebooks.shape[2]
    rc = rotate_rows(centers, rotation).reshape(n_lists, pq_dim, dsub)
    B = 2.0 * torch.einsum("lsd,scd->lsc", rc, codebooks)
    return (B + (codebooks * codebooks).sum(-1)[None]).reshape(n_lists, -1)


def _compute_b_sum(centers, rotation, codebooks, list_codes, list_ids,
                   metric: str, pq_dim: int, pq_bits: int = 8):
    """Per entry Σ_s (2·(R·c_l)_s·cb[s, code] + ‖cb[s, code]‖²) for L2,
    zeros for inner-product metrics; +inf at padding."""
    n_lists, m = list_codes.shape[0], list_codes.shape[1]
    pad_inf = torch.where(list_ids >= 0, 0.0, float("inf")).to(torch.float32)
    if metric in ("inner_product", "cosine"):
        return pad_inf
    n_codes = codebooks.shape[1]
    B = _b_table(centers, rotation, codebooks, pq_dim)
    s_off = torch.arange(pq_dim, device=centers.device) * n_codes
    out = torch.empty((n_lists, m), dtype=torch.float32, device=centers.device)
    for a, b in _list_chunks(n_lists, m * pq_dim * 12):
        codes = _codes_view(list_codes[a:b], pq_dim, pq_bits).to(torch.int64)
        idx = (codes + s_off).reshape(b - a, m * pq_dim)
        out[a:b] = torch.gather(B[a:b], 1, idx).reshape(b - a, m, pq_dim).sum(-1)
    return out + pad_inf


def build(dataset, params: IvfPqParams = IvfPqParams(),
          res: Optional[Resources] = None,
          device: Optional[DeviceLike] = None) -> IvfPqIndex:
    """Train the coarse centers (balanced k-means), a random rotation and
    per-subspace codebooks; encode and pack the lists."""
    if params.codebook_kind != "subspace":
        raise NotImplementedError(f"codebook_kind={params.codebook_kind!r} {_LATER}")
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
    if n_train < n:
        rows = torch.randint(0, n, (n_train,), generator=g_train, device=dev)
        trainset = work[rows]
        centers = kmeans_balanced.fit(trainset, params.n_lists, km, res=res)
        labels = kmeans_balanced.predict(work, centers, km, res=res)
    else:
        trainset = work
        centers, labels = kmeans_balanced.fit_predict(work, params.n_lists, km,
                                                      res=res)

    rotation = make_rotation_matrix(g_rot, rot_dim, dev)
    train_labels = kmeans_balanced.predict(trainset, centers, km, res=res)
    resid = rotate_rows(trainset - centers[train_labels], rotation)
    cb_rows = min(resid.shape[0], 65536)
    resid_cb = resid[:cb_rows].reshape(cb_rows, pq_dim, dsub)
    codebooks = _train_codebooks(resid_cb.transpose(0, 1).contiguous(), g_cb,
                                 n_codes, params.codebook_n_iters,
                                 res.workspace_bytes)

    group = params.group_size or _packing.auto_group_size(n, params.n_lists,
                                                          floor=128)
    cap = params.list_size_cap
    if cap < 0:
        cap = _packing.auto_list_cap(n, params.n_lists, group)
    if cap:
        labels = _packing.spill_to_cap(work, centers, labels, km_metric, cap)

    enc_chunk = int(max(65536, res.workspace_bytes // max(rot_dim * 16, 1)))
    parts = []
    for s in range(0, n, enc_chunk):
        lch = labels[s:s + enc_chunk]
        r = rotate_rows(work[s:s + enc_chunk] - centers[lch], rotation)
        parts.append(pack_codes(_encode(r.reshape(-1, pq_dim, dsub), codebooks),
                                params.pq_bits))
    codes = torch.cat(parts, 0)
    row_ids = torch.arange(n, dtype=torch.int32, device=dev)
    list_codes, list_ids = _packing.pack_lists(
        codes, row_ids, labels, params.n_lists, group, pow2_chunks=group == 512)
    b_sum = _compute_b_sum(centers, rotation, codebooks, list_codes, list_ids,
                           params.metric, pq_dim, params.pq_bits)
    return IvfPqIndex(centers, rotation, codebooks, list_codes, list_ids,
                      b_sum, params.metric, params.pq_bits, group,
                      params.codebook_kind, pq_dim)


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
                    n_probes: int, select_algo: str, l2: bool):
    probes, qr, pair_const = _pq_probe_prep(queries, centers, rotation,
                                            n_probes, select_algo, l2)
    bias = _ragged_bias_pq(b_sum, centers, rotation, l2)
    return probes, qr * decoded_scale, bias, pair_const


def _ragged_fused_pq(queries, index: IvfPqIndex, k: int, n_probes: int,
                     select_algo: str, l2: bool, classes, class_counts,
                     cls_ord, q_tile: int):
    """Prep, device plan, int8 strip scan (tournament allowed: the path
    over-fetches and re-ranks exactly) and finalize."""
    probes, qr_scaled, bias, pair_const = _pq_search_prep(
        queries, index.centers, index.rotation, index.b_sum,
        index.decoded_scale, n_probes, select_algo, l2)
    vals, ids = strip_scan.strip_search_traced(
        qr_scaled, probes, index.decoded, bias, index.list_ids, cls_ord,
        classes, class_counts, int(k), int(k), -2.0 if l2 else -1.0,
        q_tile, pair_const=pair_const, approx_ok=True)
    return _finalize_ragged(vals, ids, queries, index.metric)


def _search_ragged_pq(index: IvfPqIndex, queries, k: int, n_probes: int,
                      select_algo: str, res: Resources):
    if index.decoded is None:
        index.decoded, index.decoded_scale = _decode_lists(
            index.codebooks, index.list_codes, index.pq_dim, index.pq_bits)
    l2 = index.metric in ("sqeuclidean", "euclidean")
    classes, class_counts, cls_ord, q_tile = _ragged_plan_static(
        index, n_probes, k, res, int(index.decoded.shape[-1]))
    return _ragged_fused_pq(queries, index, int(k), n_probes, select_algo, l2,
                            classes, class_counts, cls_ord,
                            min(q_tile, queries.shape[0]))


def search(index: IvfPqIndex, queries, k: int, n_probes: int = 20,
           filter=None, select_algo: str = "exact", backend: str = "ragged",
           res: Optional[Resources] = None,
           device: Optional[DeviceLike] = None):
    """Approximate k-NN over the PQ lists → (distances (q, k) fp32, ids
    (q, k) int32). Distances are PQ approximations: re-rank with
    :func:`raft_tpu_torch.neighbors.refine.refine`."""
    if backend != "ragged":
        raise NotImplementedError(f"ivf_pq backend {backend!r} {_LATER}")
    if filter is not None:
        raise NotImplementedError(f"filtered ivf_pq search {_LATER}")
    if index.codebook_kind != "subspace":
        raise NotImplementedError(f"codebook_kind={index.codebook_kind!r} {_LATER}")
    if index.list_codes.shape[-1] == 0:
        raise NotImplementedError(f"cache-only streamed indexes {_LATER}")
    res = resources_for(device, res)
    if index.device != res.device:
        raise ValueError(f"index lives on {index.device}, search runs on "
                         f"{res.device}; move it with index.to(device)")
    queries = torch.as_tensor(queries).to(device=res.device, dtype=torch.float32)
    if queries.ndim != 2 or queries.shape[1] != index.dim:
        raise ValueError(f"queries must be (q, {index.dim}), got {tuple(queries.shape)}")
    n_probes = int(min(n_probes, index.n_lists))
    if not 0 < k <= n_probes * index.max_list_size:
        raise ValueError(f"k={k} out of range")
    if not (strip_scan.strip_eligible(index.max_list_size) and k <= 512):
        raise ValueError(
            f"ragged backend needs max_list_size = a power-of-two multiple of "
            f"512 and k <= 512, got {index.max_list_size} / k={k}; rebuild "
            "with group_size=512")
    if index.metric == "cosine":
        queries = queries / torch.clamp(
            torch.linalg.vector_norm(queries, dim=1, keepdim=True), min=1e-30)
    return _search_ragged_pq(index, queries, int(k), n_probes, select_algo, res)


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
    l2 = store.metric in ("sqeuclidean", "euclidean")
    probes, qr, pair_const = _pq_probe_prep(
        queries, store.centers, store.rotation, n_probes, select_algo, l2)
    vals, ids = strip_scan.paged_strip_search_traced(
        qr * store.decoded_scale, probes, cache_pool, bias_pool, page_ids,
        table, chain_pages, int(k), int(k), -2.0 if l2 else -1.0, q_tile,
        pair_const=pair_const)
    return _finalize_ragged(vals, ids, queries, store.metric)


def search_paged(store, queries, k: int, n_probes: int = 20, filter=None,
                 select_algo: str = "exact", backend: str = "auto",
                 res: Optional[Resources] = None,
                 device: Optional[DeviceLike] = None):
    """Approximate k-NN over a mutable paged code store (``PagedListStore``
    of kind ``"ivf_pq"``): :func:`search`'s contract while rows stream in
    and out. ``backend``: "paged" (K3 over the int8 cache pool) or "auto"
    (the same). Re-rank with :func:`raft_tpu_torch.neighbors.refine.refine`."""
    res, n_probes, queries = _paged_search_args(
        store, "ivf_pq", queries, k, n_probes, filter, backend, res, device)
    cache_pool, bias_pool, _, page_ids, table, chain_pages = \
        store.paged_scan_state()
    q_tile = min(_paged_plan_static(store, n_probes, k, res,
                                    store._cache_dim), queries.shape[0])
    return _paged_fused_pq(queries, store, cache_pool, bias_pool, page_ids,
                           table, chain_pages, int(k), n_probes, select_algo,
                           q_tile)
