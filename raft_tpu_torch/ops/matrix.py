"""Matrix manipulation primitives (counterpart of ``raft_tpu/ops/matrix.py``):
argmax / argmin, row gather and scatter, slicing, per-row sort, linewise
ops — one PyTorch expression each. Every entry point takes ``device=None,
res=None`` and moves its operands to :func:`resolve_device`'s answer;
results never alias the caller's tensors, as JAX arrays never do."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from raft_tpu_torch.core.resources import (DeviceLike, Resources,
                                           resolve_device, to_device)
from raft_tpu_torch.ops.linalg import matrix_vector_op


def argmax(x, axis: int = 1, device: Optional[DeviceLike] = None,
           res: Optional[Resources] = None) -> torch.Tensor:
    """int32 index of the largest entry along ``axis`` (the first, on
    ties)."""
    x = to_device(x, resolve_device(device, res))
    return torch.argmax(x, dim=axis).to(torch.int32)


def argmin(x, axis: int = 1, device: Optional[DeviceLike] = None,
           res: Optional[Resources] = None) -> torch.Tensor:
    """int32 index of the smallest entry along ``axis`` (the first, on
    ties)."""
    x = to_device(x, resolve_device(device, res))
    return torch.argmin(x, dim=axis).to(torch.int32)


def gather(x, row_ids, device: Optional[DeviceLike] = None,
           res: Optional[Resources] = None) -> torch.Tensor:
    """Rows ``row_ids`` of ``x``."""
    dev = resolve_device(device, res)
    return to_device(x, dev)[to_device(row_ids, dev).to(torch.int64)]


def scatter(x, row_ids, updates, device: Optional[DeviceLike] = None,
            res: Optional[Resources] = None) -> torch.Tensor:
    """A copy of ``x`` with rows ``row_ids`` set to ``updates``."""
    dev = resolve_device(device, res)
    out = to_device(x, dev).clone()
    rows = to_device(row_ids, dev).to(torch.int64)
    out[rows] = to_device(updates, dev).to(out.dtype)
    return out


def slice_matrix(x, rows: Tuple[int, int], cols: Tuple[int, int],
                 device: Optional[DeviceLike] = None,
                 res: Optional[Resources] = None) -> torch.Tensor:
    """The submatrix ``x[rows[0]:rows[1], cols[0]:cols[1]]`` (a copy)."""
    x = to_device(x, resolve_device(device, res))
    return x[rows[0]:rows[1], cols[0]:cols[1]].clone()


def sort_cols_per_row(x, ascending: bool = True,
                      device: Optional[DeviceLike] = None,
                      res: Optional[Resources] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row sorted → (values, int32 permutation). The sort is stable
    in both directions: tied values keep the lower column first."""
    x = to_device(x, resolve_device(device, res))
    idx = torch.argsort(x, dim=1, descending=not ascending, stable=True)
    return torch.gather(x, 1, idx), idx.to(torch.int32)


def linewise_op(x, vec, along_rows: bool = True, op: Callable = torch.mul,
                device: Optional[DeviceLike] = None,
                res: Optional[Resources] = None) -> torch.Tensor:
    """``op(x, vec)`` with ``vec`` broadcast along the rows or the
    columns (:func:`~raft_tpu_torch.ops.linalg.matrix_vector_op`)."""
    return matrix_vector_op(x, vec, axis=1 if along_rows else 0, op=op,
                            device=device, res=res)


def copy(x, device: Optional[DeviceLike] = None,
         res: Optional[Resources] = None) -> torch.Tensor:
    """A copy of ``x``."""
    return to_device(x, resolve_device(device, res)).clone()


def reverse(x, axis: int = 1, device: Optional[DeviceLike] = None,
            res: Optional[Resources] = None) -> torch.Tensor:
    """``x`` with the order along ``axis`` reversed."""
    return torch.flip(to_device(x, resolve_device(device, res)), dims=(axis,))


def init_constant(shape, value, dtype=torch.float32,
                  device: Optional[DeviceLike] = None,
                  res: Optional[Resources] = None) -> torch.Tensor:
    """A tensor of ``shape`` filled with ``value``."""
    return torch.full(tuple(shape) if not isinstance(shape, int) else (shape,),
                      value, dtype=dtype, device=resolve_device(device, res))
