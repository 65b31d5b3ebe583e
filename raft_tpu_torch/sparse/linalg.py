"""Sparse linear algebra (counterpart of ``raft_tpu/sparse/linalg.py``).

Every product is a segment reduction keyed on the CSR row expand
(``CSR.row_ids``): gather the operand's rows, scale, and ``index_add_``
them into an (n + 1)-row buffer whose last row takes the padding. CUDA's
``index_add_`` sums in no fixed order, so two runs on the card agree to
rounding, not bit for bit.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.sparse.convert import coo_sort, coo_to_csr, csr_to_coo
from raft_tpu_torch.sparse.types import COO, CSR


def _segment_sum(values: torch.Tensor, seg: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Sum of ``values`` rows by segment id in [0, n]; segment n (padding)
    is dropped."""
    out = torch.zeros((n + 1,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, seg.long(), values)
    return out[:n]


def spmv(csr: CSR, x) -> torch.Tensor:
    """y = A @ x for CSR A and dense (m,) x."""
    x = torch.as_tensor(x, device=csr.device)
    return spmm(csr, x[:, None])[:, 0]


def spmm(csr: CSR, B) -> torch.Tensor:
    """C = A @ B for CSR A (n, m) and dense B (m, k)."""
    B = torch.as_tensor(B, device=csr.device)
    n, m = csr.shape
    if B.shape[0] != m:
        raise ValueError(f"B rows {B.shape[0]} != A cols {m}")
    contrib = csr.data[:, None] * B[torch.clamp(csr.indices, 0, m - 1).long()]
    return _segment_sum(contrib, csr.row_ids(), n)


def transpose(coo: COO) -> COO:
    """Aᵀ as COO."""
    return coo_sort(COO(torch.where(coo.valid, coo.cols, -1),
                        torch.clamp(coo.rows, min=0), coo.vals,
                        (coo.shape[1], coo.shape[0])))


def add(a: COO, b: COO) -> COO:
    """A + B as COO of capacity ``a.capacity + b.capacity``; duplicate
    coordinates are kept (they sum in spmm / to_dense)."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return coo_sort(COO(torch.cat([a.rows, b.rows]),
                        torch.cat([a.cols, b.cols]),
                        torch.cat([a.vals, b.vals]), a.shape))


def symmetrize(coo: COO, mode: str = "max") -> COO:
    """Make A symmetric over the union pattern.

    ``"max"``: elementwise max(A, Aᵀ), duplicate-free — each sorted run of
    equal coordinates collapses to its last slot holding the run's max.
    ``"sum"`` / ``"mean"``: A + Aᵀ (/2), duplicates kept."""
    at = transpose(coo)
    if mode in ("sum", "mean"):
        out = add(coo, at)
        if mode == "mean":
            out = COO(out.rows, out.cols, out.vals * 0.5, out.shape)
        return out
    if mode != "max":
        raise ValueError(f"unknown mode {mode!r}")
    s = coo_sort(COO(torch.cat([coo.rows, at.rows]),
                     torch.cat([coo.cols, at.cols]),
                     torch.cat([coo.vals, at.vals]), coo.shape))
    same_prev = torch.zeros_like(s.valid)
    same_prev[1:] = (s.rows[1:] == s.rows[:-1]) & (s.cols[1:] == s.cols[:-1])
    run = torch.cumsum((~same_prev).to(torch.int64), 0) - 1
    run_max = torch.full((s.capacity,), float("-inf"), dtype=s.vals.dtype,
                         device=s.device)
    run_max = run_max.scatter_reduce(0, run, s.vals, "amax",
                                     include_self=False)[run]
    is_last = torch.ones_like(s.valid)
    is_last[:-1] = ~same_prev[1:]
    keep = is_last & s.valid
    return coo_sort(COO(torch.where(keep, s.rows, -1),
                        torch.clamp(s.cols, min=0),
                        torch.where(keep, run_max,
                                    torch.zeros_like(run_max)), s.shape))


def degree(coo: COO) -> torch.Tensor:
    """Per-row non-zero count (int32)."""
    n = coo.shape[0]
    out = torch.zeros(n, dtype=torch.int32, device=coo.device)
    return out.index_add_(0, torch.clamp(coo.rows, 0, n - 1).long(),
                          coo.valid.to(torch.int32))


def row_norm(csr: CSR, norm: str = "l2") -> torch.Tensor:
    """Per-row L1 / squared-L2 / Linf norms, as the JAX package's."""
    n = csr.shape[0]
    rid = csr.row_ids()
    if norm == "l1":
        return _segment_sum(torch.abs(csr.data), rid, n)
    if norm == "l2":
        return _segment_sum(csr.data * csr.data, rid, n)
    if norm == "linf":
        # an empty row's (and an all-zero row's) Linf norm is 0
        out = torch.zeros(n + 1, dtype=csr.data.dtype, device=csr.device)
        out = out.scatter_reduce(0, rid.long(), torch.abs(csr.data), "amax",
                                 include_self=True)
        return out[:n]
    raise ValueError(f"unknown norm {norm!r}")


def laplacian(coo: COO, normalized: bool = False) -> COO:
    """Graph Laplacian L = D − A (or I − D^-1/2 A D^-1/2) as COO of
    capacity nnz + n."""
    n, m = coo.shape
    if n != m:
        raise ValueError("laplacian needs a square adjacency")
    zero = torch.zeros_like(coo.vals)
    deg_w = torch.zeros(n, dtype=coo.vals.dtype, device=coo.device)
    deg_w.index_add_(0, torch.clamp(coo.rows, 0, n - 1).long(),
                     torch.where(coo.valid, coo.vals, zero))
    diag_r = torch.arange(n, dtype=torch.int32, device=coo.device)
    if not normalized:
        off = COO(coo.rows, coo.cols, -coo.vals, coo.shape)
        dia = COO(diag_r, diag_r, deg_w, coo.shape)
    else:
        inv_sqrt = torch.where(deg_w > 0,
                               1.0 / torch.sqrt(torch.clamp(deg_w, min=1e-30)),
                               0.0)
        r = torch.clamp(coo.rows, 0, n - 1).long()
        c = torch.clamp(coo.cols, 0, n - 1).long()
        off = COO(coo.rows, coo.cols, -coo.vals * inv_sqrt[r] * inv_sqrt[c],
                  coo.shape)
        dia = COO(diag_r, diag_r,
                  torch.where(deg_w > 0, 1.0, 0.0).to(coo.vals.dtype),
                  coo.shape)
    return add(off, dia)


__all__ = [
    "spmv", "spmm", "transpose", "add", "symmetrize", "degree", "row_norm",
    "laplacian", "coo_to_csr", "csr_to_coo",
]
