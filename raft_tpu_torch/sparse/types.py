"""Sparse containers: COO and CSR with fixed-capacity (padded) storage
(counterpart of ``raft_tpu/sparse/types.py``).

The layout is the JAX package's: a container carries a *capacity* (the
length of its entry tensors) and marks unused tail entries as padding, row
``-1`` in a COO and every entry past ``indptr[-1]`` in a CSR. Every op
treats padding as "contributes zero": padded values are stored as 0 and
padded indices are clipped into range before a gather. ``hybrid``'s
projection relies on that contract.

The entries are plain tensors (int32 indices, as in JAX), not
``torch.sparse`` tensors: those coalesce, which would drop the padding and
sum duplicates the sparse tier keeps. Tensors keep their device; a
container made from host data lands on ``device`` (``cuda`` unless the
caller asks for the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import DeviceLike, resolve_device


def _target(x, device: Optional[DeviceLike]) -> torch.device:
    """Where a container built from ``x`` lives: ``device`` if given, else
    the tensor's own device, else the default (``cuda``)."""
    if device is not None:
        return resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(None)


def _as_tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


@dataclass
class COO:
    """Coordinate-format sparse matrix. ``rows``/``cols``/``vals`` are
    (capacity,) tensors; entries with ``rows < 0`` are padding and carry
    ``vals == 0``."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    shape: Tuple[int, int]

    @property
    def capacity(self) -> int:
        return self.rows.shape[0]

    @property
    def device(self) -> torch.device:
        return self.rows.device

    @property
    def valid(self) -> torch.Tensor:
        """(capacity,) bool mask of real (non-padding) entries."""
        return self.rows >= 0

    def nnz(self) -> torch.Tensor:
        """0-d int32 count of real entries."""
        return self.valid.sum(dtype=torch.int32)

    def to_dense(self) -> torch.Tensor:
        """Densify; duplicate coordinates sum (scatter-add semantics)."""
        n, m = self.shape
        keep = self.valid
        out = torch.zeros((n, m), dtype=self.vals.dtype, device=self.device)
        out.index_put_((self.rows[keep].long(), self.cols[keep].long()),
                       self.vals[keep], accumulate=True)
        return out


@dataclass
class CSR:
    """Compressed-sparse-row matrix. ``indptr`` is (n_rows+1,);
    ``indices``/``data`` are (capacity,) with the real entries in the first
    ``indptr[-1]`` positions (padding after: data 0, indices in range)."""

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    shape: Tuple[int, int]

    @property
    def capacity(self) -> int:
        return self.indices.shape[0]

    @property
    def device(self) -> torch.device:
        return self.indices.device

    def nnz(self) -> torch.Tensor:
        return self.indptr[-1]

    def row_ids(self) -> torch.Tensor:
        """(capacity,) int32 row id per entry, the CSR expand every segment
        reduction keys on; padding entries get ``n_rows`` (one past the
        last segment)."""
        n = self.shape[0]
        pos = torch.arange(self.capacity, dtype=self.indptr.dtype,
                           device=self.device)
        rid = torch.searchsorted(self.indptr, pos, right=True) - 1
        return torch.where(pos < self.indptr[-1], rid,
                           n).to(torch.int32)

    def to_dense(self) -> torch.Tensor:
        n, m = self.shape
        rid = self.row_ids()
        keep = rid < n
        out = torch.zeros((n, m), dtype=self.data.dtype, device=self.device)
        out.index_put_((rid[keep].long(), self.indices[keep].long()),
                       self.data[keep], accumulate=True)
        return out


def coo_from_dense(dense, capacity: Optional[int] = None,
                   device: Optional[DeviceLike] = None) -> COO:
    """Non-zeros of a dense matrix, row-major, padded to ``capacity``
    (default: nnz, at least 1). nnz is data-dependent, so this reads it on
    the host, as the JAX package's host-side constructor does."""
    dev = _target(dense, device)
    d = _as_tensor(dense, dev)
    if d.ndim != 2:
        raise ValueError(f"expected a 2-D matrix, got {tuple(d.shape)}")
    r, c = torch.nonzero(d, as_tuple=True)
    v = d[r, c]
    nnz = r.shape[0]
    cap = int(capacity) if capacity is not None else max(1, nnz)
    if nnz > cap:
        raise ValueError(f"capacity {cap} < nnz {nnz}")
    pad = cap - nnz
    rows = torch.cat([r.to(torch.int32),
                      torch.full((pad,), -1, dtype=torch.int32, device=dev)])
    cols = torch.cat([c.to(torch.int32),
                      torch.zeros(pad, dtype=torch.int32, device=dev)])
    vals = torch.cat([v, torch.zeros(pad, dtype=v.dtype, device=dev)])
    return COO(rows, cols, vals, (int(d.shape[0]), int(d.shape[1])))


def csr_from_dense(dense, capacity: Optional[int] = None,
                   device: Optional[DeviceLike] = None) -> CSR:
    """Dense → CSR through :func:`coo_from_dense`."""
    from raft_tpu_torch.sparse.convert import coo_to_csr

    return coo_to_csr(coo_from_dense(dense, capacity, device))


def coo_from_parts(rows, cols, vals, shape: Tuple[int, int],
                   device: Optional[DeviceLike] = None) -> COO:
    """Wrap raw coordinate arrays (validated) into a COO; padding rows'
    values are zeroed."""
    dev = _target(rows, device)
    rows = _as_tensor(rows, dev, torch.int32)
    cols = _as_tensor(cols, dev, torch.int32)
    vals = _as_tensor(vals, dev)
    if not rows.shape == cols.shape == vals.shape or rows.ndim != 1:
        raise ValueError("rows/cols/vals must be equal-length 1-D arrays")
    vals = torch.where(rows >= 0, vals, torch.zeros_like(vals))
    return COO(rows, cols, vals, (int(shape[0]), int(shape[1])))
