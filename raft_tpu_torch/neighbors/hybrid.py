"""Hybrid dense + sparse retrieval as one fused BQ contraction
(counterpart of ``raft_tpu/neighbors/hybrid.py``).

Sparse rows (CSR / COO over a term vocabulary, :mod:`raft_tpu_torch.sparse`,
or a dense (n, vocab) block) are sign-hashed into a ``sparse_dim``-wide
block: term t lands in column h(t) mod sparse_dim with sign ±1 from bit 31
of the same 32-bit hash, so ⟨proj(a), proj(b)⟩ is an unbiased estimate of
⟨a, b⟩. The fused row ``[dense | β·proj(sparse)]`` goes into one IVF-BQ
index under ``inner_product``, which then scores
⟨q_d, x_d⟩ + β²·⟨proj(q_s), proj(x_s)⟩ in one strip scan (kernel K2); a
:func:`to_store` store scans it through K4.

The hash multiplies and shifts uint32 with wraparound. torch has no such
uint32 arithmetic on CUDA, so it runs in int64 with each product split
into 16-bit halves and masked to 32 bits: ``col`` and ``sign`` equal the
JAX package's bit for bit. The seed enters as ``seed·0x9E3779B9 + 1``,
which the JAX package converts to uint32 and so rejects (``OverflowError``)
for every seed ≥ 2; the port raises the same error.

The projection is one deterministic scatter whatever the input form:
entries are ordered by (row, column, term) and summed column by column in
term order, one pass per collision rank (each pass writes distinct
targets), so the dense, CSR and COO forms of the same rows project bit for
bit alike on the card, where a plain ``index_add_`` would sum colliding
terms in no fixed order. ``sparse_dim`` defaults to
``RAFT_TPU_HYBRID_SPARSE_DIM`` (256), as in the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.resources import (DeviceLike, Resources,
                                           resolve_device, resources_for)
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.neighbors import ivf_bq
from raft_tpu_torch.sparse.types import COO, CSR

HYBRID_SPARSE_DIM_ENV = "RAFT_TPU_HYBRID_SPARSE_DIM"

_M32 = 0xFFFFFFFF


def default_hybrid_sparse_dim() -> int:
    """Width of the hashed sparse block (``RAFT_TPU_HYBRID_SPARSE_DIM``,
    default 256)."""
    return int(os.environ.get(HYBRID_SPARSE_DIM_ENV, "256"))


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h · c) mod 2³² for int64 h in [0, 2³²) without an int64 overflow:
    the high 16 bits of h contribute only their product's low 16 bits."""
    hi = h >> 16
    lo = h & 0xFFFF
    return ((((hi * c) & 0xFFFF) << 16) + lo * c) & _M32


def _hash_cols_signs(term_ids, sparse_dim: int, seed: int):
    """Deterministic term → (column int32, sign fp32) feature hash: one
    32-bit xorshift-multiply finalizer per term id."""
    s = int(seed) * 0x9E3779B9 + 1
    if not 0 <= s <= _M32:
        raise OverflowError(f"Python integer {s} out of bounds for uint32")
    h = (torch.as_tensor(term_ids).to(torch.int64) & _M32) ^ s
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    col = (h % int(sparse_dim)).to(torch.int32)
    sign = torch.where((h >> 31) > 0, 1.0, -1.0).to(torch.float32)
    return col, sign


def _entries(sp, device: Optional[DeviceLike]):
    """(rows, terms, vals, n) of the real non-zero entries of ``sp``."""
    if isinstance(sp, CSR):
        rid = sp.row_ids()
        keep = rid < sp.shape[0]
        return (rid[keep], torch.clamp(sp.indices[keep], min=0),
                sp.data[keep], sp.shape[0])
    if isinstance(sp, COO):
        keep = sp.valid
        return (sp.rows[keep], torch.clamp(sp.cols[keep], min=0),
                sp.vals[keep], sp.shape[0])
    if isinstance(sp, torch.Tensor):
        dense = sp if device is None else sp.to(resolve_device(device))
    else:
        dense = torch.from_numpy(np.ascontiguousarray(
            np.asarray(sp, dtype=np.float32))).to(resolve_device(device))
    if dense.ndim != 2:
        raise ValueError(f"expected 2-D sparse rows, got {tuple(dense.shape)}")
    r, t = torch.nonzero(dense, as_tuple=True)
    return r, t, dense[r, t], dense.shape[0]


def project_sparse(sp, sparse_dim: Optional[int] = None, seed: int = 0,
                   device: Optional[DeviceLike] = None) -> torch.Tensor:
    """Sign-hash sparse rows into a dense ``(n, sparse_dim)`` fp32 block.

    ``sp``: a :class:`~raft_tpu_torch.sparse.types.CSR` or
    :class:`~raft_tpu_torch.sparse.types.COO` (padding contributes zero) or
    a dense ``(n, vocab)`` block; containers and tensors keep their device,
    host data goes to ``device`` (``cuda`` unless the caller asks for the
    CPU). Colliding terms add with their signs."""
    dim = default_hybrid_sparse_dim() if sparse_dim is None else int(sparse_dim)
    if dim <= 0:
        raise ValueError(f"sparse_dim must be positive, got {dim}")
    rows, terms, vals, n = _entries(sp, device)
    col, sign = _hash_cols_signs(terms, dim, seed)
    vals = vals.to(torch.float32)
    keep = vals != 0
    target = rows.to(torch.int64)[keep] * dim + col[keep]
    terms = terms.to(torch.int64)[keep]
    v = (vals * sign)[keep]
    # (target, term) order; each pass adds one collision rank, to distinct
    # targets, so every column sums its terms in term order
    order = torch.argsort(terms, stable=True)
    order = order[torch.argsort(target[order], stable=True)]
    target, v = target[order], v[order]
    out = torch.zeros(n * dim, dtype=torch.float32, device=v.device)
    e = target.numel()
    if e:
        idx = torch.arange(e, device=v.device)
        new = torch.ones(e, dtype=torch.bool, device=v.device)
        new[1:] = target[1:] != target[:-1]
        rank = idx - torch.cummax(torch.where(new, idx, 0), 0).values
        for j in range(int(rank.max()) + 1):
            m = rank == j
            out.index_add_(0, target[m], v[m])
    return out.reshape(n, dim)


@dataclass(frozen=True)
class HybridIndex:
    """An :class:`~raft_tpu_torch.neighbors.ivf_bq.IvfBqIndex` over fused
    ``[dense | β·proj(sparse)]`` rows, with the projection's parameters."""

    index: ivf_bq.IvfBqIndex
    dense_dim: int
    sparse_dim: int
    beta: float
    seed: int = 0

    @property
    def n_lists(self) -> int:
        return self.index.n_lists

    @property
    def dim(self) -> int:
        return self.index.dim


@traced("hybrid::build")
def build(dense, sparse, params: Optional[ivf_bq.IvfBqParams] = None,
          beta: float = 1.0, sparse_dim: Optional[int] = None, seed: int = 0,
          res: Optional[Resources] = None,
          device: Optional[DeviceLike] = None) -> HybridIndex:
    """Hash-project ``sparse``, β-scale, concat onto ``dense`` and build
    IVF-BQ over the result under ``inner_product`` (the only metric whose
    concat score is dense + β²·sparse; any other raises)."""
    res = resources_for(device, res)
    dense = torch.as_tensor(dense).to(device=res.device, dtype=torch.float32)
    if dense.ndim != 2:
        raise ValueError(f"dense rows must be (n, d), got {tuple(dense.shape)}")
    sdim = default_hybrid_sparse_dim() if sparse_dim is None else int(sparse_dim)
    params = params or ivf_bq.IvfBqParams(metric="inner_product")
    if params.metric != "inner_product":
        raise ValueError(
            "hybrid fusion requires metric='inner_product' (the concat "
            f"score only decomposes there), got {params.metric!r}")
    proj = project_sparse(sparse, sdim, seed, device=res.device)
    if proj.shape[0] != dense.shape[0]:
        raise ValueError(
            f"dense has {dense.shape[0]} rows, sparse {proj.shape[0]}")
    fused = torch.cat([dense, float(beta) * proj], dim=1)
    if obs.enabled():
        obs.add("hybrid.build.rows", int(fused.shape[0]))
    with obs.record_span("hybrid::build",
                         attrs={"rows": int(fused.shape[0]),
                                "dense_dim": int(dense.shape[1]),
                                "sparse_dim": sdim, "beta": float(beta)}):
        inner = ivf_bq.build(fused, params, res=res)
    return HybridIndex(inner, int(dense.shape[1]), sdim, float(beta),
                       int(seed))


def fuse_queries(hybrid: HybridIndex, dense_q, sparse_q) -> torch.Tensor:
    """Queries in the fused space, ``[q_d | β·proj(q_s)]``, on the index's
    device: the serving entry for hybrid stores,
    ``serving.search(to_store(h), fuse_queries(h, qd, qs), k)``."""
    dev = hybrid.index.device
    dense_q = torch.as_tensor(dense_q).to(device=dev, dtype=torch.float32)
    if dense_q.ndim != 2 or dense_q.shape[1] != hybrid.dense_dim:
        raise ValueError(
            f"queries must be (q, {hybrid.dense_dim}), got "
            f"{tuple(dense_q.shape)}")
    proj = project_sparse(sparse_q, hybrid.sparse_dim, hybrid.seed,
                          device=dev).to(dev)
    return torch.cat([dense_q, hybrid.beta * proj], dim=1)


@traced("hybrid::search")
def search(hybrid: HybridIndex, dense_q, sparse_q, k: int, n_probes: int = 20,
           filter=None, res: Optional[Resources] = None,
           device: Optional[DeviceLike] = None,
           **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused hybrid k-NN: one BQ strip scan over the concat → (scores,
    indices), scores in IVF-BQ's negated-inner-product order. ``filter``
    and every other IVF-BQ search knob pass straight through."""
    fused_q = fuse_queries(hybrid, dense_q, sparse_q)
    if obs.enabled():
        obs.add("hybrid.searches")
    with obs.record_span("hybrid::search",
                         attrs={"queries": int(fused_q.shape[0]),
                                "k": int(k), "n_probes": int(n_probes),
                                "filtered": filter is not None}):
        return ivf_bq.search(hybrid.index, fused_q, k, n_probes=n_probes,
                             filter=filter, res=res, device=device, **kwargs)


def to_store(hybrid: HybridIndex, **kwargs):
    """The fused index as a paged serving store (kind ``"ivf_bq"``, kernel
    K4). Upserts must be fused rows; queries go through
    :func:`fuse_queries`."""
    from raft_tpu_torch.serving import PagedListStore

    return PagedListStore.from_index(hybrid.index, **kwargs)
