"""Build and load the port's hand-written CUDA kernel.

The source under ``ops/csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, and loaded
with ``ctypes``. Nothing is prebuilt: the first call on a machine with a
card builds into ``raft_tpu_torch/_build/`` (listed in ``.gitignore``),
keyed by a hash of the source and flags, so an edited source rebuilds and
an unchanged one loads at once.

Every kernel wrapper owns a :class:`KernelCounter` and adds one to it where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCE = CSRC / "strip_scan.cu"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: Optional[ctypes.CDLL] = None


@dataclass
class KernelCounter:
    """Launch count of one hand-written kernel (a plain integer)."""

    name: str
    launches: int = 0

    def reset(self) -> None:
        self.launches = 0


def nvcc() -> str:
    """Path of the CUDA compiler: PyTorch's detected CUDA home, else PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                           "machine with the card, from the CUDA toolkit")
    return found


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{SOURCE.stem}-{h.hexdigest()[:16]}.so"


def build() -> Optional[float]:
    """Compile the kernel library if it is not built yet. Returns nvcc's
    wall seconds (None when already built); raises with nvcc's output on
    failure."""
    out = library_path()
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: nvcc exit {proc.returncode}\n"
                           f"{proc.stdout.decode(errors='replace')}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _loaded
    with _lock:
        if _loaded is None:
            build()
            _loaded = ctypes.CDLL(str(library_path()))
        return _loaded
