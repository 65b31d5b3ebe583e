"""Native (C++) host components of the port, bound with ``ctypes``
(counterpart of ``raft_tpu/native/``).

One library today: ``hnsw_writer.cpp``, the streaming hnswlib-format
writer. It is built with ``g++`` on first use into
``raft_tpu_torch/_build/`` (listed in ``.gitignore``), keyed by a hash of
its source and flags as ``ops/_native.py`` keys the CUDA sources, so an
edited source rebuilds and an unchanged one loads at once. This is host
code, not a device kernel: where no compiler is found the callers write
through their pure-Python twin (``neighbors/hnsw.py``), which writes the
same bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "hnsw_writer.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path(source: Path = SOURCE) -> Path:
    """Where ``source``'s library lives: named by the hash of its text and
    the flags."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def _build(source: Path) -> Optional[Path]:
    out = library_path(source)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(source), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    tmp.replace(out)
    return out


def get_native_lib() -> Optional[ctypes.CDLL]:
    """The writer's library, built on first use; None where no ``g++``
    builds it (the callers then write through the Python twin)."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build(SOURCE)
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.raft_torch_write_hnsw.restype = ctypes.c_int
        lib.raft_torch_write_hnsw.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_float), ctypes.c_uint64]
        _lib = lib
        return _lib
