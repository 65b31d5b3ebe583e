"""Pooled per-device :class:`Resources` for multi-threaded servers
(counterpart of ``raft_tpu/core/resources_manager.py``).

One :class:`Resources` per ``torch.device``, made on its first checkout
and shared after that, behind one lock. There is no stream or key to hand
out: PyTorch orders work on the device's current stream, and every
algorithm that draws numbers builds its own ``torch.Generator`` from its
params' seed.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from raft_tpu_torch.core.resources import (DeviceLike, Resources,
                                           resolve_device)

_LOCK = threading.Lock()
_POOL: dict = {}
_DEFAULTS: dict = {}


def set_resource_defaults(workspace_bytes: Optional[int] = None,
                          compute_dtype: Optional[torch.dtype] = None
                          ) -> None:
    """Defaults for pool entries created after this call (entries already
    in the pool keep theirs)."""
    with _LOCK:
        if workspace_bytes is not None:
            _DEFAULTS["workspace_bytes"] = int(workspace_bytes)
        if compute_dtype is not None:
            _DEFAULTS["compute_dtype"] = compute_dtype


def get_resources(device: Optional[DeviceLike] = None) -> Resources:
    """The pooled :class:`Resources` of ``device`` (``cuda`` by default,
    which raises without a card; ``"cpu"`` on request). Repeated calls
    from any thread return the same instance."""
    dev = resolve_device(device if device is not None else "cuda")
    with _LOCK:
        res = _POOL.get(dev)
        if res is None:
            res = Resources(device=dev, **_DEFAULTS)
            _POOL[dev] = res
        return res


def clear_pool() -> None:
    """Drop every pooled entry (tests, reconfiguration)."""
    with _LOCK:
        _POOL.clear()
