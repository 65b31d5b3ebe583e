"""The v2 index container, byte-compatible with ``raft_tpu.core.serialize``.

A file written by either package loads in the other, so an index built by
the JAX package can be searched by the port and back::

    magic  b"RAFTTPU\\0"  (8 bytes)
    version uint32 LE
    meta_len uint64 LE, meta = UTF-8 JSON (scalar params, array order,
                                           per-array byte length and CRC32)
    for each array in meta["arrays"]: a standard .npy blob, in order

Arrays may be numpy arrays or tensors (written from host memory); loads
return numpy arrays, which callers move to their device. Path saves are
atomic (``core/fsio.atomic_write``: temp file, fsync, rename). Version-1
files (no lengths or CRCs) still load. The ``serialize.save.write``
faultpoint sits mid-write (after the header, before the arrays) and
``serialize.load.read`` before every read.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.fsio import atomic_write
from raft_tpu_torch.resilience import faultpoint

_MAGIC = b"RAFTTPU\x00"
_VERSION = 2


class SnapshotCorruptError(ValueError):
    """A container failed its integrity check (truncation, CRC mismatch,
    garbage header)."""


def _host(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def serialize_array(stream, arr) -> None:
    np.save(stream, _host(arr), allow_pickle=False)


def deserialize_array(stream) -> np.ndarray:
    return np.load(stream, allow_pickle=False)


class _CrcSink(io.RawIOBase):
    """Write sink that folds CRC32 and counts bytes, storing nothing."""

    def __init__(self):
        self.count = 0
        self.crc = 0

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        self.crc = zlib.crc32(b, self.crc) & 0xFFFFFFFF
        self.count += len(b)
        return len(b)


def save_arrays(path_or_stream, meta: Mapping[str, Any],
                arrays: Mapping[str, Any]) -> None:
    """Save a JSON-meta + named-array container. Lengths and CRCs precede
    the payloads, so each array is serialized twice: once into a counting
    sink, then for real."""
    host = {name: _host(a) for name, a in arrays.items()}
    meta = dict(meta)
    meta["arrays"] = list(host.keys())
    meta["array_bytes"] = {}
    meta["array_crc32"] = {}
    for name in meta["arrays"]:
        sink = _CrcSink()
        serialize_array(sink, host[name])
        meta["array_bytes"][name] = sink.count
        meta["array_crc32"][name] = sink.crc

    def write_to(stream) -> None:
        blob_meta = json.dumps(meta).encode("utf-8")
        stream.write(_MAGIC)
        stream.write(struct.pack("<I", _VERSION))
        stream.write(struct.pack("<Q", len(blob_meta)))
        stream.write(blob_meta)
        # mid-write injection site: a fatal here leaves the target whole
        faultpoint("serialize.save.write")
        for name in meta["arrays"]:
            serialize_array(stream, host[name])

    if isinstance(path_or_stream, (str, bytes, os.PathLike)):
        with atomic_write(path_or_stream) as stream:
            write_to(stream)
    else:
        write_to(path_or_stream)


def _load_v2(stream, meta) -> Dict[str, np.ndarray]:
    sizes = meta.get("array_bytes", {})
    crcs = meta.get("array_crc32", {})
    arrays: Dict[str, np.ndarray] = {}
    for name in meta["arrays"]:
        want = int(sizes[name])
        blob = stream.read(want)
        if len(blob) < want:
            raise SnapshotCorruptError(
                f"truncated container: array {name!r} has {len(blob)} of "
                f"{want} bytes")
        got_crc = zlib.crc32(blob) & 0xFFFFFFFF
        if got_crc != int(crcs[name]):
            raise SnapshotCorruptError(
                f"corrupt container: array {name!r} CRC32 {got_crc:#010x} != "
                f"recorded {int(crcs[name]):#010x}")
        try:
            arrays[name] = deserialize_array(io.BytesIO(blob))
        except ValueError as e:
            raise SnapshotCorruptError(
                f"corrupt container: array {name!r} passed CRC but failed "
                f"npy parse: {e!r}") from e
    return arrays


def load_arrays(path_or_stream) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """Load a container written by either package's ``save_arrays``."""
    faultpoint("serialize.load.read")
    own = isinstance(path_or_stream, (str, bytes, os.PathLike))
    stream = open(path_or_stream, "rb") if own else path_or_stream
    try:
        magic = stream.read(8)
        if magic != _MAGIC:
            raise ValueError(f"bad magic {magic!r}: not a raft_tpu container")
        head = stream.read(4)
        if len(head) < 4:
            raise SnapshotCorruptError(
                "truncated container: file ends inside the version field")
        (version,) = struct.unpack("<I", head)
        if version > _VERSION:
            raise ValueError(f"unsupported container version {version}")
        head = stream.read(8)
        if len(head) < 8:
            raise SnapshotCorruptError(
                "truncated container: file ends inside the meta length")
        (meta_len,) = struct.unpack("<Q", head)
        raw_meta = stream.read(meta_len)
        if len(raw_meta) < meta_len:
            raise SnapshotCorruptError(
                f"truncated container: meta block has {len(raw_meta)} of "
                f"{meta_len} bytes")
        try:
            meta = json.loads(raw_meta.decode("utf-8"))
        except ValueError as e:  # UnicodeDecodeError, JSONDecodeError
            raise SnapshotCorruptError(f"corrupt container meta: {e!r}") from e
        if version >= 2:
            arrays = _load_v2(stream, meta)
        else:
            arrays = {name: deserialize_array(stream) for name in meta["arrays"]}
        return meta, arrays
    finally:
        if own:
            stream.close()
