"""Build and load the port's hand-written CUDA kernels.

Every ``*.cu`` source under ``ops/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library with a plain C interface,
and loaded with ``ctypes``. Nothing is prebuilt: the first call on a
machine with a card builds into ``raft_tpu_torch/_build/`` (listed in
``.gitignore``), one ``nvcc`` per source, all started together. Each
library is keyed by a hash of its source, the shared headers (``*.cuh``)
and the flags, so an edited source or header rebuilds and an unchanged one
loads at once.

Every kernel wrapper owns a :class:`KernelCounter` and adds one to it where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernel.

A source that does not build or a library that does not load raises
:class:`NativeBuildError`, which ``resilience.classify`` holds FATAL
whatever the compiler printed: no retry re-runs a kernel that failed to
build. A launch that returns a CUDA error raises a ``RuntimeError`` with
:func:`launch_message`'s text, which reads "out of memory" for
``cudaErrorMemoryAllocation`` and so classifies OOM.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# ptxas reports each kernel's registers, stack frame and spills into the
# build log: a kernel that falls off a register cliff shows there
PTXAS_FLAGS = ("-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}

#: cudaError_t codes a launch may return that the launch errors name
_CUDA_ERRORS = {1: "cudaErrorInvalidValue",
                2: "cudaErrorMemoryAllocation: out of memory",
                98: "cudaErrorInvalidDeviceFunction",
                209: "cudaErrorNoKernelImageForDevice"}


class NativeBuildError(RuntimeError):
    """A kernel source failed to build (nvcc missing or failing) or its
    library failed to load."""


def launch_message(kernel: str, rc: int) -> str:
    """The text of the ``RuntimeError`` a wrapper raises when its launch
    returned CUDA error ``rc``; it names the error
    (``cudaErrorMemoryAllocation`` reads "out of memory", which classifies
    OOM)."""
    name = _CUDA_ERRORS.get(int(rc), "")
    return (f"{kernel} kernel launch failed: CUDA error {rc}"
            + (f" ({name})" if name else ""))


@dataclass
class KernelCounter:
    """Launch count of one hand-written kernel (a plain integer) and, for a
    kernel with more than one product loop, the loop its last launch ran
    (one of :data:`PRODUCT_LOOPS`; empty until it launched)."""

    name: str
    launches: int = 0
    loop: str = ""

    def reset(self) -> None:
        self.launches = 0
        self.loop = ""


#: the strip kernels' product loops, by the code their ``raft_*_loop``
#: entries return: ``mma.sync`` (strip_kernel), ``wgmma`` (strip_kernel_wg,
#: staged or register-A), ``ring`` (strip_kernel_wg's paged ring, K3)
PRODUCT_LOOPS = ("mma.sync", "wgmma", "ring")


def last_loop(name: str) -> str:
    """The product loop of the last launch from ``csrc/<name>.cu``'s
    library, as its ``raft_<name>_loop`` entry reports it."""
    fn = getattr(load(name), f"raft_{name}_loop")
    fn.restype = ctypes.c_int
    return PRODUCT_LOOPS[fn()]


def sources() -> List[Path]:
    """The kernel sources, one library each."""
    return sorted(CSRC.glob("*.cu"))


def headers() -> List[Path]:
    """The headers every source may include."""
    return sorted(CSRC.glob("*.cuh"))


def nvcc() -> str:
    """Path of the CUDA compiler: PyTorch's detected CUDA home, else PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise NativeBuildError("nvcc not found: the CUDA kernels are built on the "
                           "machine with the card, from the CUDA toolkit")
    return found


def library_path(source: Path) -> Path:
    """Where ``source``'s library is built, keyed by its content, the
    headers' and the flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in headers():
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build() -> Optional[float]:
    """Compile every kernel library not built yet, one ``nvcc`` per source,
    all at once, keeping each one's nvcc log (ptxas's resource report)
    beside its library. Returns the wall seconds (None when all were
    built); raises with nvcc's output if any source fails."""
    todo = [(src, library_path(src)) for src in sources()]
    todo = [(src, out) for src, out in todo if not out.exists()]
    if not todo:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, *PTXAS_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        except OSError as e:
            raise NativeBuildError(f"nvcc did not start: {e}") from e
        procs.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}: nvcc exit {proc.returncode}\n"
                          f"{log.decode(errors='replace')}")
        else:
            out.with_suffix(".log").write_bytes(log)
            os.replace(tmp, out)
    if failed:
        raise NativeBuildError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def parse_ptxas(log: str) -> List[dict]:
    """Each kernel's resources from an ``nvcc -Xptxas -v`` log:
    ``{"kernel", "registers", "stack_bytes", "spill_store_bytes"}``, names
    demangled by the toolkit's ``cu++filt`` where it sits beside nvcc."""
    usage, name, frame = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, frame = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and name:
            frame = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage.append({"kernel": name, "registers": int(m.group(1)),
                          "stack_bytes": frame[0],
                          "spill_store_bytes": frame[1]})
            name = None
    filt = Path(nvcc()).with_name("cu++filt")
    if usage and filt.is_file():
        names = subprocess.run(
            [str(filt)], input="\n".join(u["kernel"] for u in usage),
            capture_output=True, text=True, check=True).stdout.splitlines()
        for u, n in zip(usage, names):
            u["kernel"] = n
    return usage


def resource_usage(source: Path) -> List[dict]:
    """:func:`parse_ptxas` of the build log of ``source``'s library (empty
    when that library was not built by :func:`build` here)."""
    log = library_path(source).with_suffix(".log")
    return parse_ptxas(log.read_text(errors="replace")) if log.is_file() \
        else []


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building first if needed.
    Each build-and-load lands in the compile ledger as ``native.<name>``
    keyed by the library's hash, with the wall clock of the build and the
    load (``obs.compile.watch``): a library loads once a process, so a
    second record under the same hash is an unexplained retrace."""
    from raft_tpu_torch.obs import compile as obs_compile

    with _lock:
        if name not in _loaded:
            source = CSRC / f"{name}.cu"
            if not source.is_file():
                raise NativeBuildError(f"no kernel source {source}")
            path = library_path(source)
            with obs_compile.watch():
                if not path.exists():
                    build()
                try:
                    _loaded[name] = ctypes.CDLL(str(path))
                except OSError as e:
                    raise NativeBuildError(
                        f"kernel library {name} did not load: {e}") from e
                obs_compile.native_event(f"native.{name}",
                                         library=path.name)
        return _loaded[name]
