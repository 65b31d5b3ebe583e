"""Sparse pairwise distances (counterpart of ``raft_tpu/sparse/distance.py``).

Densify by tiles, then reuse the dense distances: each row tile of x (and
of y, when y does not fit the workspace whole) is scattered into a dense
block and handed to :func:`raft_tpu_torch.ops.distance.pairwise_distance`,
so every dense metric works here unchanged. ``backend="expand"`` is the
JAX package's nnz expansion over a padded ELL layout (l2 / ip / cosine
only): an independent oracle for the dense route. ``"auto"`` is always
the dense route, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.ops import distance as dense_distance
from raft_tpu_torch.sparse.linalg import _segment_sum
from raft_tpu_torch.sparse.types import CSR


def _densify_rows(csr: CSR, start: int, n_rows_tile: int) -> torch.Tensor:
    """Scatter rows [start, start + n_rows_tile) into a dense block."""
    _, m = csr.shape
    local = csr.row_ids().to(torch.int64) - start
    in_tile = (local >= 0) & (local < n_rows_tile)
    out = torch.zeros((n_rows_tile, m), dtype=csr.data.dtype,
                      device=csr.device)
    out.index_put_((local[in_tile],
                    torch.clamp(csr.indices[in_tile], 0, m - 1).long()),
                   csr.data[in_tile], accumulate=True)
    return out


def _to_ell(csr: CSR, width_round: int = 8):
    """CSR → padded ELL: (cols (n, w), vals (n, w), w) with w the largest
    row nnz rounded up to ``width_round``; padding slots point at column 0
    with value 0."""
    n, m = csr.shape
    rid = csr.row_ids().to(torch.int64)
    valid = rid < n
    counts = torch.bincount(rid[valid], minlength=n)
    w = int(counts.max()) if csr.capacity and n else 1
    w = max(width_round, -(-w // width_round) * width_round)
    rv = rid[valid]
    pos = torch.arange(csr.capacity, device=csr.device)[valid] \
        - csr.indptr[:-1].to(torch.int64)[rv]
    cols = torch.zeros((n, w), dtype=torch.int32, device=csr.device)
    cols[rv, pos] = torch.clamp(csr.indices[valid], 0, m - 1).to(torch.int32)
    vals = torch.zeros((n, w), dtype=csr.data.dtype, device=csr.device)
    vals[rv, pos] = csr.data[valid]
    return cols, vals, w


def _expand_ip(x: CSR, y: CSR, res: Resources) -> torch.Tensor:
    """Sparse × sparse inner products by nnz expansion: x as padded ELL,
    y as a transposed dense tile, ip[i, :] = Σ_k vals[i, k]·Yᵀ[cols[i, k], :].
    Work is nx·w·ny (w the largest row nnz)."""
    nx, m = x.shape
    ny = y.shape[0]
    cols, vals, w = _to_ell(x)
    ny_tile = (ny if m * ny * 4 <= res.workspace_bytes // 4
               else max(1, (res.workspace_bytes // 4) // max(m * 4, 1)))
    per_row = max(1, w * ny_tile * 4 * 2)
    x_tile = int(max(1, min(nx, (res.workspace_bytes // 2) // per_row)))
    out_rows = []
    for sx in range(0, nx, x_tile):
        c_t = cols[sx:sx + x_tile]
        v_t = vals[sx:sx + x_tile].to(torch.float32)
        tx = c_t.shape[0]
        parts = []
        for sy in range(0, ny, ny_tile):
            ty = min(ny_tile, ny - sy)
            yT = _densify_rows(y, sy, ty).T.to(torch.float32)      # (m, ty)
            g = yT[c_t.reshape(-1).long()].reshape(tx, w, ty)
            parts.append(torch.einsum("rk,rkn->rn", v_t, g))
        out_rows.append(torch.cat(parts, dim=1))
    return torch.cat(out_rows, dim=0)


def _row_sqnorms(csr: CSR) -> torch.Tensor:
    return _segment_sum(csr.data * csr.data, csr.row_ids(), csr.shape[0])


_EXPAND_METRICS = ("sqeuclidean", "euclidean", "inner_product", "cosine")


def pairwise_distance(x: CSR, y: Optional[CSR] = None,
                      metric: str = "sqeuclidean", p: float = 2.0,
                      res: Optional[Resources] = None, backend: str = "auto",
                      device: Optional[DeviceLike] = None) -> torch.Tensor:
    """All-pairs (x_rows, y_rows) distances between CSR operands under any
    metric of :func:`raft_tpu_torch.ops.distance.pairwise_distance`.

    ``backend``: ``"auto"`` (always the dense route), ``"dense"``
    (densify by tiles, every metric) or ``"expand"`` (nnz expansion,
    l2 / ip / cosine only)."""
    res = resources_for(device, res)
    y = x if y is None else y
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"dim mismatch: {x.shape} vs {y.shape}")
    if backend not in ("auto", "dense", "expand"):
        raise ValueError(f"unknown sparse distance backend {backend!r}")
    for a in (x, y):
        if a.device != res.device:
            raise ValueError(f"operand lives on {a.device}, the distance "
                             f"runs on {res.device}")
    nx, m = x.shape
    ny = y.shape[0]
    canon = dense_distance.canonical_metric(metric)
    if backend == "expand" and canon not in _EXPAND_METRICS:
        raise ValueError(
            f"backend='expand' supports {_EXPAND_METRICS}, got {metric!r} "
            "(use backend='dense')")
    if backend == "expand" and nx and ny:
        ip = _expand_ip(x, y, res)
        if canon == "inner_product":
            return ip
        xs = _row_sqnorms(x).to(torch.float32)
        ys = _row_sqnorms(y).to(torch.float32)
        if canon == "cosine":
            denom = torch.sqrt(torch.clamp(xs[:, None] * ys[None, :],
                                           min=1e-30))
            return 1.0 - ip / denom
        d = torch.clamp(xs[:, None] + ys[None, :] - 2.0 * ip, min=0.0)
        return torch.sqrt(d) if canon == "euclidean" else d

    if nx == 0 or ny == 0:
        return torch.zeros((nx, ny), dtype=torch.float32, device=res.device)
    if ny * m * 4 <= res.workspace_bytes // 2:
        y_tile = ny
    else:
        y_tile = int(max(1, (res.workspace_bytes // 2) // max(m * 4, 1)))
    # the x tile holds full ny-wide output rows until the concat
    bytes_per_row = max(1, (m + ny) * 4 * 2)
    tile = int(max(1, min(nx, (res.workspace_bytes // 2) // bytes_per_row)))
    yd_whole = _densify_rows(y, 0, ny) if y_tile == ny else None
    rows = []
    for s in range(0, nx, tile):
        t = min(tile, nx - s)
        xd = _densify_rows(x, s, t)
        parts = []
        for sy in range(0, ny, y_tile):
            ty = min(y_tile, ny - sy)
            yd = yd_whole if yd_whole is not None else _densify_rows(y, sy, ty)
            parts.append(dense_distance.pairwise_distance(xd, yd, metric, p=p,
                                                          res=res))
        rows.append(torch.cat(parts, dim=1))
    return torch.cat(rows, dim=0)
