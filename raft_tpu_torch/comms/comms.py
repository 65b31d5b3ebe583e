"""``comms_t``-shaped collectives over a list of shards (counterpart of
``raft_tpu/comms/comms.py``).

The JAX package is single-controller SPMD: a :class:`Comms` wraps a mesh
axis, ``Comms.run`` is ``shard_map`` and its bodies call ``lax``
collectives by axis name. The port keeps the model and splits each body at
its collectives: a per-shard phase (a plain function on one shard's
tensors, run for every shard this process holds, in rank order) and
module-level collectives over the list of per-shard results. Every
collective takes ``xs``, one tensor per local shard in ``comms.local``
order, and returns such a list.

Two transports sit behind one :class:`Comms`, and no algorithm branches
on which:

* ``local`` — every shard lives in this process, each bound to a
  ``torch.device`` (several shards may share one). Tensors move between
  shards with ``.to(device)``. The tests run it on the CPU and one H100
  runs it with every shard on the card.
* ``process_group`` — one shard a ``torch.distributed`` rank; the
  collectives are ``torch.distributed``'s (NCCL for CUDA tensors, gloo for
  CPU tensors) and ``sendrecv`` is ``batch_isend_irecv``. It is the
  counterpart of a multi-host mesh after ``init_distributed``.

Semantics, as the JAX package documents them:

* ``reduce`` / ``gather`` are symmetric: every rank gets the result, only
  ``root``'s copy is the contract.
* There is no ``allgatherv``: variable-length gathers pad to the maximum
  and carry a validity mask.
* ``sendrecv`` takes a static permutation of (src, dst) pairs; ranks that
  receive nothing get zeros.
* A float reduction on the ``local`` transport sums in rank order
  (r0 + r1 + …). XLA's all-reduce and NCCL's ring or tree may associate
  the terms otherwise, so float sums agree with theirs to rounding (the
  tests hold them at rtol 1e-6); integer sums and max / min agree exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_REDUCE_OPS = ("sum", "max", "min")
TRANSPORTS = ("local", "process_group")


@dataclass
class Mesh:
    """A grid of shards: ``devices`` is an object array of ``torch.device``
    shaped like the mesh (flat rank g is ``devices.flat[g]``),
    ``axis_names`` names its axes. ``local_ranks`` are the flat ranks this
    process holds (all of them on the ``local`` transport, its own on
    ``process_group``). ``process_groups`` maps an axis name to the
    ``torch.distributed`` group of this rank's line along it (None: the
    default group)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    transport: str = "local"
    local_ranks: Tuple[int, ...] = ()
    process_groups: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}, got "
                             f"{self.transport!r}")
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh shape {self.devices.shape} vs axis_names "
                             f"{self.axis_names}")
        kinds = sorted({torch.device(d).type for d in self.devices.flat})
        if len(kinds) > 1:
            # the scan engine and the CAGRA traversal are chosen once for
            # the mesh: a CUDA shard beside a CPU one would run the twins
            raise ValueError(f"a mesh's shards must share one device type, "
                             f"found {kinds}")
        if not self.local_ranks:
            self.local_ranks = tuple(range(self.devices.size))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _axis_groups(shape: Tuple[int, ...], axis_index: int) -> List[List[int]]:
    """The flat ranks of every line of the mesh along one axis, each in the
    axis' order (a rank's position in its line is its rank there)."""
    flat = np.arange(int(np.prod(shape))).reshape(shape)
    lines = np.moveaxis(flat, axis_index, -1).reshape(-1, shape[axis_index])
    return [[int(g) for g in line] for line in lines]


class Comms:
    """A communicator: one mesh axis of a :class:`Mesh` (the ``comms_t``
    that ``resources`` holds, core/resource/comms.hpp:64).

    ``size`` is the axis' length; a collective reduces within each line of
    the mesh along the axis. ``local`` are the flat ranks this process
    holds, the order of every per-shard list; ``devices`` their devices."""

    def __init__(self, mesh: Mesh, axis: Optional[str] = None):
        self.mesh = mesh
        if axis is None:
            if len(mesh.axis_names) != 1:
                raise ValueError(
                    f"mesh has axes {mesh.axis_names}; pass axis= explicitly")
            axis = mesh.axis_names[0]
        if axis not in mesh.axis_names:
            raise ValueError(f"axis {axis!r} not in mesh axes "
                             f"{mesh.axis_names}")
        self.axis = axis
        self.groups = _axis_groups(mesh.devices.shape,
                                   mesh.axis_names.index(axis))
        self._group_of = {g: line for line in self.groups for g in line}
        self.local = tuple(mesh.local_ranks)
        self._slot = {g: i for i, g in enumerate(self.local)}

    @property
    def size(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def transport(self) -> str:
        return self.mesh.transport

    @property
    def devices(self) -> List[torch.device]:
        """The device of every local shard, in ``local`` order."""
        return [self.mesh.devices.flat[g] for g in self.local]

    def rank_of(self, g: int) -> int:
        """Flat rank ``g``'s rank on this communicator's axis."""
        return self._group_of[g].index(g)

    @property
    def ranks(self) -> List[int]:
        """The axis rank of every local shard (``get_rank`` per shard)."""
        return [self.rank_of(g) for g in self.local]

    def map(self, fn: Callable, *per_shard) -> list:
        """One per-shard phase: ``fn(rank, *shard_args)`` for every local
        shard in rank order, each argument list in ``local`` order."""
        return [fn(self.rank_of(g), *(a[i] for a in per_shard))
                for i, g in enumerate(self.local)]

    def replicate(self, x) -> List[torch.Tensor]:
        """``x`` on every local shard's device."""
        x = torch.as_tensor(x)
        return [x.to(d) for d in self.devices]

    def shard_rows(self, x) -> List[torch.Tensor]:
        """Each local shard's contiguous block of ``x``'s rows (the row
        count divides by ``size``), on its device."""
        x = torch.as_tensor(x)
        if x.shape[0] % self.size:
            raise ValueError(f"{x.shape[0]} rows do not divide by "
                             f"{self.size} shards")
        per = x.shape[0] // self.size
        return [x[r * per:(r + 1) * per].to(d)
                for r, d in zip(self.ranks, self.devices)]

    def split(self, rows: int, cols: int,
              names: Tuple[str, str] = ("row", "col")
              ) -> Tuple["Comms", "Comms"]:
        """comm_split (core/comms.hpp:131): this 1-D communicator as a
        (rows, cols) mesh → the row- and col-axis communicators. Every
        shard sits in one row line and one col line, as NCCL's comm_split
        by colour. On ``process_group`` every process creates every line's
        group (``torch.distributed.new_group``), in one order."""
        if rows * cols != self.size:
            raise ValueError(f"rows*cols = {rows * cols} != communicator "
                             f"size {self.size}")
        if len(self.mesh.axis_names) != 1:
            raise ValueError("split takes a 1-D communicator")
        grid = self.mesh.devices.reshape(rows, cols)
        pgs = {}
        if self.transport == "process_group":
            import torch.distributed as dist

            me = self.local[0]
            for ai, name in enumerate(names):
                for line in _axis_groups((rows, cols), ai):
                    handle = dist.new_group(line)
                    if me in line:
                        pgs[name] = handle
        mesh2 = Mesh(grid, tuple(names), self.transport, self.local, pgs)
        return Comms(mesh2, names[0]), Comms(mesh2, names[1])

    # -- collective plumbing ----------------------------------------------

    def _pg(self):
        return self.mesh.process_groups.get(self.axis)

    def _lines(self, xs: Sequence[torch.Tensor]):
        """Local transport: each line's shard values in axis order, with
        their local slots."""
        if len(xs) != len(self.local):
            raise ValueError(f"expected one tensor per local shard "
                             f"({len(self.local)}), got {len(xs)}")
        for line in self.groups:
            yield [self._slot[g] for g in line]


# ---------------------------------------------------------------------------
# Collectives (xs: one tensor per local shard, in comms.local order)
# ---------------------------------------------------------------------------


def get_size(comms: Comms) -> int:
    """Communicator size (comms_t::get_size)."""
    return comms.size


def get_rank(comms: Comms) -> List[int]:
    """Each local shard's rank on the axis (comms_t::get_rank)."""
    return comms.ranks


def _dist_op(op: str):
    import torch.distributed as dist

    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
            "min": dist.ReduceOp.MIN}[op]


def allreduce(comms: Comms, xs, op: str = "sum") -> List[torch.Tensor]:
    """All-reduce with ``op`` in {sum, max, min} (comms_t::allreduce, the
    JAX package's psum / pmax / pmin). Local sums run in rank order."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"allreduce op must be one of {_REDUCE_OPS}, "
                         f"got {op!r}")
    if comms.transport == "process_group":
        import torch.distributed as dist

        t = xs[0].clone()
        dist.all_reduce(t, op=_dist_op(op), group=comms._pg())
        return [t]
    out = [None] * len(xs)
    fold = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}[op]
    for slots in comms._lines(xs):
        acc = xs[slots[0]].clone()
        for s in slots[1:]:
            acc = fold(acc, xs[s].to(acc.device))
        for s in slots:
            out[s] = acc.to(comms.devices[s], copy=True)
    return out


def reduce(comms: Comms, xs, root: int = 0, op: str = "sum"):
    """Reduce to ``root`` (comms_t::reduce): computed on every rank, only
    ``root``'s copy is the contract."""
    return allreduce(comms, xs, op)


def bcast(comms: Comms, xs, root: int = 0) -> List[torch.Tensor]:
    """``root``'s value on every rank (comms_t::bcast)."""
    if comms.transport == "process_group":
        import torch.distributed as dist

        t = xs[0].clone()
        src = comms._group_of[comms.local[0]][root]
        dist.broadcast(t, src=src, group=comms._pg())
        return [t]
    out = [None] * len(xs)
    for slots in comms._lines(xs):
        for s in slots:
            out[s] = xs[slots[root]].to(comms.devices[s], copy=True)
    return out


def allgather(comms: Comms, xs, tiled: bool = False,
              gather_axis: int = 0) -> List[torch.Tensor]:
    """Every rank's value, concatenated (``tiled``) or stacked along
    ``gather_axis`` in rank order (comms_t::allgather)."""
    join = torch.cat if tiled else torch.stack
    if comms.transport == "process_group":
        import torch.distributed as dist

        parts = [torch.empty_like(xs[0]) for _ in range(comms.size)]
        dist.all_gather(parts, xs[0].contiguous(), group=comms._pg())
        return [join(parts, dim=gather_axis)]
    out = [None] * len(xs)
    for slots in comms._lines(xs):
        dev0 = comms.devices[slots[0]]
        full = join([xs[s].to(dev0) for s in slots], dim=gather_axis)
        for s in slots:
            out[s] = full.to(comms.devices[s], copy=True)
    return out


def gather(comms: Comms, xs, root: int = 0, tiled: bool = False):
    """Gather to ``root`` (comms_t::gather): every rank gets it, only
    ``root``'s copy is the contract."""
    return allgather(comms, xs, tiled=tiled, gather_axis=0)


def reducescatter(comms: Comms, xs, op: str = "sum",
                  scatter_axis: int = 0) -> List[torch.Tensor]:
    """Sum, then rank i keeps block i of ``scatter_axis`` (whose length
    divides by ``size``) (comms_t::reducescatter)."""
    if op != "sum":
        raise ValueError("reducescatter supports op='sum' (ncclSum analog) "
                         "only")
    full = allreduce(comms, xs, "sum")
    n = full[0].shape[scatter_axis]
    if n % comms.size:
        raise ValueError(f"axis {scatter_axis} of length {n} does not divide "
                         f"by {comms.size} ranks")
    per = n // comms.size
    return [f.narrow(scatter_axis, r * per, per).contiguous()
            for f, r in zip(full, comms.ranks)]


def sendrecv(comms: Comms, xs,
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Static point-to-point exchange (comms_t::device_sendrecv, the JAX
    package's ppermute): ``perm`` holds (src, dst) axis-rank pairs; a rank
    that receives nothing gets zeros."""
    perm = [(int(s), int(d)) for s, d in perm]
    if comms.transport == "process_group":
        import torch.distributed as dist

        me = comms.ranks[0]
        line = comms._group_of[comms.local[0]]
        x = xs[0].contiguous()
        out = torch.zeros_like(x)
        ops = []
        for s, d in perm:
            if s == me and d == me:
                out = x.clone()
            elif s == me:
                ops.append(dist.P2POp(dist.isend, x, line[d],
                                      group=comms._pg()))
            elif d == me:
                ops.append(dist.P2POp(dist.irecv, out, line[s],
                                      group=comms._pg()))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [out]
    out = [None] * len(xs)
    for slots in comms._lines(xs):
        for s in slots:
            out[s] = torch.zeros_like(xs[s])
        for src, dst in perm:
            out[slots[dst]] = xs[slots[src]].to(comms.devices[slots[dst]],
                                                copy=True)
    return out


def shift(comms: Comms, xs, offset: int = 1) -> List[torch.Tensor]:
    """Ring shift by ``offset``: rank i's value goes to rank i + offset."""
    n = comms.size
    return sendrecv(comms, xs, [(i, (i + offset) % n) for i in range(n)])


def barrier(comms: Comms) -> int:
    """Every rank arrives before any leaves (comms_t::barrier); returns the
    communicator size. On ``local`` each shard's device is synchronised."""
    if comms.transport == "process_group":
        import torch.distributed as dist

        dist.barrier(group=comms._pg())
    else:
        for d in set(comms.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
    return comms.size


def shard_padded(x, comms: Comms, fill=0.0) -> Tuple[List[torch.Tensor], int]:
    """Pad ``x``'s rows to a multiple of the communicator size and give
    each local shard its block → (blocks, n_padded): the one padding
    convention of every distributed algorithm (callers mask pad rows by
    global id or give them weight 0)."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    n_padded = -(-n // comms.size) * comms.size
    if n_padded != n:
        pad = torch.full((n_padded - n,) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad], dim=0)
    return comms.shard_rows(x), n_padded


def make_comms(res=None, axis: str = "data") -> Comms:
    """A Comms over the current Resources' mesh (set_comms / get_comms:
    the mesh slot of :class:`~raft_tpu_torch.core.resources.Resources` is
    the installed communicator)."""
    from raft_tpu_torch.core.resources import current_resources

    res = res or current_resources()
    return Comms(res.default_mesh(axis), axis)
