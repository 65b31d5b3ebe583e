"""Execution context — the PyTorch counterpart of ``raft_tpu.core.resources``.

What stays context-like in the port: which device to run on, the workspace
budget tiled algorithms size their tiles from, and the dtype fed to
matmul-heavy paths. Randomness is not a context resource here: every
algorithm that draws numbers builds its own ``torch.Generator`` from its
params' ``seed``.

Device rule: an entry point runs on ``cuda`` unless the caller asks for the
CPU. With no card and no CPU request it raises ``RuntimeError`` — it never
falls back to the CPU quietly.

TF32 is switched off for fp32 matmuls and cuDNN convolutions when this
module is imported: ``raft_tpu``'s primitives default to
``precision="highest"`` (``raft_tpu/ops/distance.py`` ``matmul_t``), so the
port's fp32 products stay full fp32.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Optional, Union

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[str, torch.device]


@dataclass
class Resources:
    """Execution context for raft_tpu_torch calls. Entry points take
    ``res=None`` and fall back to :func:`current_resources`.

    Attributes:
      device: where entry points run; ``"cuda"`` by default.
      workspace_bytes: soft budget tiled algorithms use to pick tile sizes.
      compute_dtype: dtype of the coarse gemm inputs (fp32 accumulation).
      mesh: optional default :class:`~raft_tpu_torch.comms.comms.Mesh` of
        the distributed algorithms (the installed communicator).
    """

    device: DeviceLike = "cuda"
    workspace_bytes: int = 1 << 30
    compute_dtype: torch.dtype = torch.float32
    mesh: Optional[Any] = None

    def default_mesh(self, axis_name: str = "data"):
        """The mesh distributed algorithms run over: the installed
        ``mesh``; else, once ``torch.distributed`` is initialised, one
        shard a rank (``process_group``); else one shard per visible card
        when ``device`` is CUDA (raising without one), one shard on
        ``device`` otherwise."""
        from raft_tpu_torch.comms import bootstrap

        if self.mesh is not None:
            return self.mesh
        if bootstrap.distributed_ready():
            return bootstrap.process_group_mesh((axis_name,))
        dev = resolve_device(self.device)
        if dev.type == "cuda":
            return bootstrap.local_mesh(axis_names=(axis_name,))
        return bootstrap.local_mesh(1, (axis_name,), device=dev)


def resolve_device(device: Optional[DeviceLike] = None,
                   res: Optional[Resources] = None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else
    ``res.device``, else the scoped :func:`current_resources` (``cuda``
    unless a :func:`use_resources` scope says otherwise). Raises ``RuntimeError`` when that is a
    CUDA device and no card is present."""
    if device is None:
        device = (res if res is not None else current_resources()).device
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "raft_tpu_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' (or Resources(device='cpu')) to "
                "run on the CPU")
        if dev.index is None:  # name the card, so device checks compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(x, dev: torch.device) -> torch.Tensor:
    """``x`` — a tensor, a numpy array (negative strides and read-only
    arrays included, copied first) or a nested sequence — as a tensor on
    ``dev``."""
    if isinstance(x, np.ndarray) and (not x.flags.writeable
                                      or any(st < 0 for st in x.strides)):
        x = x.copy()
    return torch.as_tensor(x).to(dev)


def resources_for(device: Optional[DeviceLike] = None,
                  res: Optional[Resources] = None) -> Resources:
    """``res`` with its device resolved (and overridden by ``device``)."""
    res = res or current_resources()
    return Resources(resolve_device(device, res), res.workspace_bytes,
                     res.compute_dtype, res.mesh)


_tls = threading.local()


def current_resources() -> Resources:
    """The innermost :func:`use_resources` scope of this thread, else a
    fresh default :class:`Resources` (``cuda``)."""
    stack = getattr(_tls, "stack", None)
    if stack:
        return stack[-1]
    return Resources()


@contextlib.contextmanager
def use_resources(res: Resources):
    """Scope ``res`` as the current context within the ``with`` block (per
    thread)."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(res)
    try:
        yield res
    finally:
        stack.pop()
