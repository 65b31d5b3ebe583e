"""COO <-> CSR <-> dense conversions (counterpart of
``raft_tpu/sparse/convert.py``). Capacity in equals capacity out; the only
host reads are in the ``*_from_dense`` constructors of
:mod:`raft_tpu_torch.sparse.types`, where nnz is data-dependent."""

from __future__ import annotations

import torch

from raft_tpu_torch.sparse.types import COO, CSR

_INT32_MAX = torch.iinfo(torch.int32).max


def coo_sort(coo: COO) -> COO:
    """Sort entries by (row, col), padding last; stable, as two stable
    key sorts (minor key first)."""
    prim = torch.where(coo.valid, coo.rows, _INT32_MAX)
    order = torch.argsort(coo.cols, stable=True)
    order = order[torch.argsort(prim[order], stable=True)]
    return COO(coo.rows[order], coo.cols[order], coo.vals[order], coo.shape)


def coo_to_csr(coo: COO) -> CSR:
    """COO → CSR of the same capacity."""
    n, _ = coo.shape
    s = coo_sort(coo)
    counts = torch.zeros(n, dtype=torch.int32, device=coo.device)
    counts.index_add_(0, s.rows.clamp(0, n - 1).long(),
                      s.valid.to(torch.int32))
    indptr = torch.cat([torch.zeros(1, dtype=torch.int32, device=coo.device),
                        torch.cumsum(counts, 0, dtype=torch.int32)])
    return CSR(indptr, torch.clamp(s.cols, min=0),
               torch.where(s.valid, s.vals, torch.zeros_like(s.vals)),
               coo.shape)


def csr_to_coo(csr: CSR) -> COO:
    """CSR → COO of the same capacity."""
    rid = csr.row_ids()
    valid = rid < csr.shape[0]
    rows = torch.where(valid, rid, -1).to(torch.int32)
    return COO(rows, torch.where(valid, csr.indices, 0).to(torch.int32),
               torch.where(valid, csr.data, torch.zeros_like(csr.data)),
               csr.shape)
