"""Sparse structural ops: sort, filter, slice, row ops (counterpart of
``raft_tpu/sparse/op.py``). Capacity is kept: a removed entry becomes
padding (row -1, zero data), never a reshape."""

from __future__ import annotations

import torch

from raft_tpu_torch.sparse.convert import coo_sort, coo_to_csr, csr_to_coo
from raft_tpu_torch.sparse.types import COO, CSR

sort = coo_sort


def filter_entries(coo: COO, keep_mask) -> COO:
    """Entries where ``keep_mask`` is False become padding, and a re-sort
    moves them to the end."""
    keep = torch.as_tensor(keep_mask, device=coo.device).to(torch.bool) \
        & coo.valid
    return coo_sort(COO(torch.where(keep, coo.rows, -1),
                        torch.where(keep, coo.cols, 0),
                        torch.where(keep, coo.vals,
                                    torch.zeros_like(coo.vals)),
                        coo.shape))


def remove_scalar(coo: COO, scalar=0.0) -> COO:
    """Drop entries equal to ``scalar``."""
    return filter_entries(coo, coo.vals != scalar)


def slice_rows(csr: CSR, start: int, stop: int) -> CSR:
    """Rows [start, stop) with the same capacity; the slice's entries move
    to the first ``new_nnz`` slots."""
    n, m = csr.shape
    start, stop = int(start), int(stop)
    if not 0 <= start <= stop <= n:
        raise ValueError(f"bad slice [{start}, {stop}) for {n} rows")
    lo, hi = csr.indptr[start], csr.indptr[stop]
    pos = torch.arange(csr.capacity, dtype=csr.indptr.dtype,
                       device=csr.device)
    src = torch.clamp(pos + lo, 0, csr.capacity - 1).long()
    in_slice = pos < (hi - lo)
    indices = torch.where(in_slice, csr.indices[src], 0)
    data = torch.where(in_slice, csr.data[src], torch.zeros_like(csr.data))
    if stop > start:
        indptr = torch.minimum(torch.clamp(csr.indptr[start:stop + 1] - lo,
                                           min=0), hi - lo)
    else:
        indptr = torch.zeros(1, dtype=csr.indptr.dtype, device=csr.device)
    return CSR(indptr, indices, data, (stop - start, m))


def row_scale(csr: CSR, scales) -> CSR:
    """Scale each row by ``scales[row]``."""
    scales = torch.as_tensor(scales, device=csr.device)
    rid = torch.clamp(csr.row_ids(), 0, csr.shape[0] - 1).long()
    return CSR(csr.indptr, csr.indices, csr.data * scales[rid], csr.shape)


__all__ = ["sort", "filter_entries", "remove_scalar", "slice_rows",
           "row_scale", "coo_to_csr", "csr_to_coo"]
