"""Distributed communication layer (counterpart of ``raft_tpu/comms``).

A :class:`Comms` is one axis of a :class:`Mesh` of shards; the
collectives (module functions of :mod:`~raft_tpu_torch.comms.comms`) take
one tensor per shard this process holds and return one per shard. Two
transports: ``local`` (every shard in this process, :func:`local_mesh`)
and ``process_group`` (one shard a ``torch.distributed`` rank, after
:func:`init_distributed`, :func:`process_group_mesh`).
"""

from raft_tpu_torch.comms.bootstrap import (init_distributed, local_mesh,
                                            process_group_mesh,
                                            shutdown_distributed)
from raft_tpu_torch.comms.comms import (Comms, Mesh, allgather, allreduce,
                                        barrier, bcast, gather, get_rank,
                                        get_size, make_comms, reduce,
                                        reducescatter, sendrecv, shift)
from raft_tpu_torch.comms.self_test import comms_self_test

__all__ = [
    "Comms", "Mesh", "allgather", "allreduce", "barrier", "bcast",
    "comms_self_test", "gather", "get_rank", "get_size", "init_distributed",
    "local_mesh", "make_comms", "process_group_mesh", "reduce",
    "reducescatter", "sendrecv", "shift", "shutdown_distributed",
]
