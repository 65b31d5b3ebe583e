"""Device-memory accounting (counterpart of ``raft_tpu/obs/memory.py``):
watermarks as gauges and span attributes.

* :func:`device_stats` — per-card ``bytes_in_use`` / ``peak_bytes_in_use``
  from the CUDA caching allocator (``torch.cuda.memory_stats``) and the
  card's total (``torch.cuda.mem_get_info``) as ``bytes_limit``;
* :func:`live_bytes` — the fallback: ``torch.cuda.memory_allocated()``
  where a CUDA context exists, else the bytes of every live CPU tensor,
  deduplicated by storage (the counterpart of ``jax.live_arrays()``);
* :func:`sample` — one watermark for a named scope, recorded as
  ``memory.<tag>.*`` gauges and returned as a dict;
* :func:`index_bytes` / :func:`record_index` — an index's or store's
  residency: ``nbytes`` summed over its tensor- and array-valued fields,
  one level deep.

Never creates a CUDA context: every CUDA read is gated on
``torch.cuda.is_initialized()``, just as the JAX module never initialises
a backend, so a telemetry read costs nothing on a process that has not
touched the card.
"""

from __future__ import annotations

import gc
import sys

from raft_tpu_torch import obs

__all__ = [
    "device_stats",
    "index_bytes",
    "live_bytes",
    "record_index",
    "sample",
]


def _live_cuda():
    """The torch module only when a CUDA context already exists."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return torch


def device_stats() -> list:
    """Per-card memory stats: ``[{"device", "platform", "bytes_in_use",
    "peak_bytes_in_use", "bytes_limit"}, ...]``. Empty when no CUDA context
    exists (the CPU, or a process that has not touched the card)."""
    torch = _live_cuda()
    if torch is None:
        return []
    out = []
    for dev in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(dev)
        in_use = int(stats.get("allocated_bytes.all.current", 0))
        row = {
            "device": str(dev),
            "platform": "gpu",
            "bytes_in_use": in_use,
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               in_use)),
        }
        _, total = torch.cuda.mem_get_info(dev)
        if total:
            row["bytes_limit"] = int(total)
        out.append(row)
    return out


def live_bytes() -> int:
    """Bytes the process holds in tensors: the caching allocator's
    allocated bytes where a CUDA context exists, else every live CPU
    tensor's bytes, each storage counted once (views and aliases share a
    storage)."""
    torch = _live_cuda()
    if torch is not None:
        return int(sum(torch.cuda.memory_allocated(d)
                       for d in range(torch.cuda.device_count())))
    torch = sys.modules.get("torch")
    if torch is None:
        return 0
    total = 0
    seen = set()
    for obj in gc.get_objects():
        # type(), not isinstance: isinstance reads __class__, which some
        # deprecated module-level proxies answer with a warning
        if not issubclass(type(obj), torch.Tensor) or obj.is_meta:
            continue
        storage = obj.untyped_storage()
        key = (storage.data_ptr(), obj.device.type)
        if key in seen or storage.data_ptr() == 0:
            continue
        seen.add(key)
        total += int(storage.nbytes())
    return total


def sample(tag: str) -> dict:
    """One memory watermark for scope ``tag``: ``{"source",
    "bytes_in_use", "peak_bytes_in_use", "per_device"?}``. Source is
    ``"device_stats"`` where the card's allocator reports and
    ``"live_arrays"`` otherwise. Recorded as ``memory.<tag>.bytes_in_use``
    / ``.peak_bytes`` gauges."""
    with obs.record_span("obs.memory::sample", attrs={"tag": tag}):
        per_dev = device_stats()
        if per_dev:
            out = {
                "source": "device_stats",
                "bytes_in_use": sum(d["bytes_in_use"] for d in per_dev),
                "peak_bytes_in_use": sum(
                    d["peak_bytes_in_use"] for d in per_dev),
                "per_device": per_dev,
            }
        else:
            b = live_bytes()
            out = {"source": "live_arrays", "bytes_in_use": b,
                   "peak_bytes_in_use": b}
        if obs.enabled():
            obs.set_gauge(f"memory.{tag}.bytes_in_use", out["bytes_in_use"])
            obs.set_gauge(f"memory.{tag}.peak_bytes",
                          out["peak_bytes_in_use"])
        return out


def index_bytes(index) -> int:
    """Resident bytes of one index or store: ``nbytes`` summed over its
    tensor- and array-valued fields (instance attributes, dataclass fields
    and slots, one level deep)."""
    total = 0
    seen = set()
    fields = {}
    src = getattr(index, "__dict__", None)
    if src:
        fields.update(src)
    for name in getattr(type(index), "__dataclass_fields__", ()) or ():
        fields.setdefault(name, getattr(index, name, None))
    for slot in getattr(type(index), "__slots__", ()) or ():
        fields.setdefault(slot, getattr(index, slot, None))
    for val in fields.values():
        nbytes = getattr(val, "nbytes", None)
        if isinstance(nbytes, int) and id(val) not in seen:
            seen.add(id(val))
            total += nbytes
    return total


def record_index(name: str, index) -> int:
    """Record ``index``'s residency as the ``memory.index.<name>.bytes``
    gauge; returns the byte count."""
    b = index_bytes(index)
    if obs.enabled():
        obs.set_gauge(f"memory.index.{name}.bytes", b)
    return b
