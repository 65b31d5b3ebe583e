"""Shared utilities (counterpart of ``raft_tpu/utils``): the tiling helpers
of the out-of-core algorithms. Names load on first access."""

from raft_tpu_torch._lazy import attach

__getattr__, __dir__ = attach(__name__, {
    "pad_rows": ("tiling", "pad_rows"),
    "pad_and_tile": ("tiling", "pad_and_tile"),
    "ceil_div": ("tiling", "ceil_div"),
})

__all__ = ["pad_rows", "pad_and_tile", "ceil_div"]
