"""Cluster bootstrap and meshes (counterpart of
``raft_tpu/comms/bootstrap.py``, the raft-dask ``Comms.init()`` analog).

:func:`local_mesh` is a mesh of shards in this process (the
LocalCUDACluster analog): with no ``device``, one shard per visible card,
raising without one like every entry point; with ``device="cuda"`` or
``device="cpu"``, ``n_devices`` shards on that one device, the counterpart
of the JAX package's virtual CPU devices (the tests run it on the CPU, one
H100 runs it on the card). It is never chosen silently.

:func:`init_distributed` joins a ``torch.distributed`` process group (the
``ncclCommInitRank`` rendezvous analog; JAX's ``jax.distributed.initialize``)
and :func:`process_group_mesh` then gives one shard a rank. The rendezvous
sources, in order, and what they stand for in the JAX package:

==========================  ===========================  ======================
argument                    PyTorch variable (torchrun)  JAX variable
==========================  ===========================  ======================
``coordinator_address``     ``MASTER_ADDR:MASTER_PORT``  ``JAX_COORDINATOR_ADDRESS``
``num_processes``           ``WORLD_SIZE``               ``JAX_NUM_PROCESSES``
``process_id``              ``RANK``                     ``JAX_PROCESS_ID``
==========================  ===========================  ======================

The backend follows the device rule: ``nccl`` when the current
:class:`~raft_tpu_torch.core.resources.Resources` device is CUDA (raising
without a card), ``gloo`` when it is the CPU. A process's card is its rank
modulo the visible cards.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.comms.comms import Mesh
from raft_tpu_torch.core.resources import (DeviceLike, current_resources,
                                           resolve_device)

# hard bound on the subprocess-isolated coordinator probe: the verdict
# arrives in seconds, whatever the child does
PROBE_MAX_TIMEOUT = 20.0

_PROBE_SENTINEL = "RAFT_TPU_COMMS_OK"
_state = {"done": False}


def _probe_coordinator(addr: str, timeout: float) -> None:
    """Reachability check of ``host:port`` in a bounded child process
    before the in-process rendezvous commits. The child polls until the
    port accepts or ``timeout`` passes: the rank-0 process opens the
    rendezvous store in its own ``init_process_group``, so a peer that
    starts first finds nothing listening yet. Raises a TRANSIENT-classified
    error when the coordinator stays unreachable."""
    host, sep, port = addr.rpartition(":")
    if not sep or not port.isdigit():
        return  # unparseable: let torch.distributed report it
    timeout = min(float(timeout), PROBE_MAX_TIMEOUT)
    code = (
        "import socket, time\n"
        f"end = time.monotonic() + {timeout}\n"
        "while True:\n"
        "    try:\n"
        f"        socket.create_connection(({host!r}, {int(port)}), "
        "timeout=1.0).close()\n"
        "        break\n"
        "    except OSError:\n"
        "        if time.monotonic() > end:\n"
        "            raise\n"
        "        time.sleep(0.1)\n"
        f"print({_PROBE_SENTINEL!r}, flush=True)\n"
    )
    try:
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True,
                              timeout=timeout + 5.0)
    except subprocess.TimeoutExpired:
        # "timed out" would classify DEADLINE (no retry); an unreachable
        # coordinator is the TRANSIENT, retry-worthy case
        raise RuntimeError(
            f"UNAVAILABLE: coordinator probe to {addr} got no connection "
            f"within {timeout:g}s") from None
    if _PROBE_SENTINEL not in (proc.stdout or ""):
        raise RuntimeError(
            f"UNAVAILABLE: coordinator {addr} unreachable "
            f"(probe rc={proc.returncode}: {(proc.stderr or '')[-300:]})")


def distributed_ready() -> bool:
    """True once this process is in a ``torch.distributed`` group."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     auto: bool = False, timeout_s: float = 60.0,
                     probe: bool = True) -> bool:
    """Join the process group (the ncclCommInitRank rendezvous analog).

    Sources, in order: the arguments, then PyTorch's rendezvous variables
    (module docstring); ``auto=True`` with neither rendezvouses from the
    environment alone (``init_method="env://"``). Returns False (nothing
    done) when no source is given and ``auto`` is off, True once joined; a
    second call returns True at once.

    Before the handshake a bounded child probes the coordinator (not on
    rank 0, which hosts it); the probe and the handshake each get one
    TRANSIENT retry with deterministic backoff, behind the
    ``comms.init_distributed`` faultpoint, and ``timeout_s`` bounds the
    rendezvous."""
    if _state["done"] or distributed_ready():
        _state["done"] = True
        return True
    import torch.distributed as dist

    from raft_tpu_torch.resilience import RetryPolicy, faultpoint, with_retries

    retry_once = RetryPolicy(max_retries=1, base_delay_s=0.5, max_delay_s=2.0)
    env = os.environ
    addr = coordinator_address
    if addr is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    nproc = (num_processes if num_processes is not None
             else env.get("WORLD_SIZE"))
    pid = process_id if process_id is not None else env.get("RANK")
    timeout = datetime.timedelta(seconds=max(1.0, float(timeout_s)))

    def _initialize(**kwargs) -> None:
        # inside the retried callable: an armed fault takes the recovery
        # path a real transient handshake failure takes
        faultpoint("comms.init_distributed")
        dev = resolve_device(None, current_resources())
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                timeout=timeout, **kwargs)

    if addr is None and nproc is None:
        if not auto:
            return False
        with_retries(lambda: _initialize(init_method="env://"), retry_once,
                     site="comms.init_distributed")
        _state["done"] = True
        return True
    if addr is None or nproc is None or pid is None:
        raise ValueError(
            "init_distributed needs the coordinator address, the process "
            "count and this process's id (arguments or MASTER_ADDR / "
            "MASTER_PORT / WORLD_SIZE / RANK)")
    if probe and int(pid) != 0:
        with_retries(lambda: _probe_coordinator(addr, timeout_s / 4.0),
                     retry_once, site="comms.init_distributed.probe")
    with_retries(lambda: _initialize(init_method=f"tcp://{addr}",
                                     world_size=int(nproc), rank=int(pid)),
                 retry_once, site="comms.init_distributed")
    _state["done"] = True
    return True


def shutdown_distributed() -> None:
    """Leave the process group (``destroy_process_group``); a later
    :func:`init_distributed` joins anew."""
    import torch.distributed as dist

    if distributed_ready():
        dist.destroy_process_group()
    _state["done"] = False


def _grid(devs, axis_names, shape):
    grid = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        grid[i] = d
    if shape is not None:
        grid = grid.reshape(tuple(shape))
    if grid.ndim != len(axis_names):
        raise ValueError(f"mesh shape {grid.shape} vs axis_names {axis_names}")
    return grid


def local_mesh(n_devices: Optional[int] = None,
               axis_names: Tuple[str, ...] = ("data",),
               shape: Optional[Sequence[int]] = None, *,
               device: Optional[DeviceLike] = None) -> Mesh:
    """A mesh of shards in this process (``local`` transport). With no
    ``device``: the first ``n_devices`` visible cards, one shard each
    (raises without a card). With ``device``: ``n_devices`` shards (1 by
    default) on that one device. ``shape`` reshapes the shards for a
    multi-axis mesh."""
    if device is None:
        resolve_device("cuda")             # raises without a card
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            if n_devices > len(devs):
                raise ValueError(f"requested {n_devices} devices, have "
                                 f"{len(devs)}")
            devs = devs[:n_devices]
    else:
        devs = [resolve_device(device)] * (1 if n_devices is None
                                           else int(n_devices))
    if not devs:
        raise ValueError("a mesh needs at least one shard")
    return Mesh(_grid(devs, tuple(axis_names), shape), tuple(axis_names))


def process_group_mesh(axis_names: Tuple[str, ...] = ("data",)) -> Mesh:
    """A 1-D mesh of one shard per ``torch.distributed`` rank
    (``process_group`` transport), this process holding its own; its
    device is this rank's card under NCCL, the CPU under gloo. Split it
    with ``Comms.split`` for a 2-D layout."""
    import torch.distributed as dist

    if not distributed_ready():
        raise RuntimeError("process_group_mesh needs init_distributed first")
    if len(axis_names) != 1:
        raise ValueError("process_group_mesh is 1-D; use Comms.split")
    world, rank = dist.get_world_size(), dist.get_rank()
    if dist.get_backend() == "nccl":
        me = torch.device("cuda", rank % max(1, torch.cuda.device_count()))
    else:
        me = torch.device("cpu")
    return Mesh(_grid([me] * world, tuple(axis_names), None),
                tuple(axis_names), "process_group", (rank,),
                {axis_names[0]: None})
