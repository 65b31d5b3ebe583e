"""Core runtime (counterpart of ``raft_tpu/core``): the execution context,
the v2 container format, atomic file writes, logging, bitsets and
cooperative interruption. Names load on first access."""

from raft_tpu_torch._lazy import attach

__getattr__, __dir__ = attach(__name__, {
    "Resources": ("resources", "Resources"),
    "current_resources": ("resources", "current_resources"),
    "use_resources": ("resources", "use_resources"),
    "SnapshotCorruptError": ("serialize", "SnapshotCorruptError"),
    "serialize_array": ("serialize", "serialize_array"),
    "deserialize_array": ("serialize", "deserialize_array"),
    "save_arrays": ("serialize", "save_arrays"),
    "load_arrays": ("serialize", "load_arrays"),
    "atomic_write": ("fsio", "atomic_write"),
    "atomic_replace": ("fsio", "atomic_replace"),
    "Bitset": ("bitset", "Bitset"),
    "get_logger": ("logger", "get_logger"),
    "set_level": ("logger", "set_level"),
    "InterruptedException": ("interruptible", "InterruptedException"),
    "check_interrupt": ("interruptible", "check_interrupt"),
    "cancel": ("interruptible", "cancel"),
    "clear": ("interruptible", "clear"),
})

__all__ = [
    "Resources", "SnapshotCorruptError", "atomic_replace", "atomic_write",
    "current_resources", "use_resources", "serialize_array",
    "deserialize_array", "save_arrays", "load_arrays", "Bitset",
    "get_logger", "set_level", "InterruptedException", "check_interrupt",
    "cancel", "clear",
]
