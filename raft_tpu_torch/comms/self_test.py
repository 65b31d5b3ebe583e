"""Per-collective boolean self-tests (counterpart of
``raft_tpu/comms/self_test.py``; reference comms/comms_test.hpp:34-144).

One boolean test per collective and p2p op, each comparing the collective
over a mesh axis with a host-computed expectation; :func:`comms_self_test`
runs all nine on either transport and returns ``{name: ok}``. Shard i
holds the value i (or a vector built from it), as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from raft_tpu_torch.comms import comms as C


def _per_rank(comm: C.Comms, fn, dtype=torch.float32):
    """One tensor per local shard: ``fn(rank)`` on the shard's device."""
    return [torch.as_tensor(np.asarray(fn(r)), dtype=dtype, device=d)
            for r, d in zip(comm.ranks, comm.devices)]


def _host(xs):
    return [x.cpu().numpy() for x in xs]


def test_allreduce(comm: C.Comms) -> bool:
    n = comm.size
    xs = _per_rank(comm, lambda r: [float(r)])
    ok_sum = all(np.allclose(v, n * (n - 1) / 2.0)
                 for v in _host(C.allreduce(comm, xs, "sum")))
    ok_max = all(np.allclose(v, n - 1.0)
                 for v in _host(C.allreduce(comm, xs, "max")))
    return bool(ok_sum and ok_max)


def test_bcast(comm: C.Comms, root: int = 0) -> bool:
    xs = _per_rank(comm, lambda r: [(r + 1) * 10.0])
    return all(np.allclose(v, (root + 1) * 10.0)
               for v in _host(C.bcast(comm, xs, root)))


def test_reduce(comm: C.Comms, root: int = 0) -> bool:
    xs = _per_rank(comm, lambda r: [1.0])
    out = _host(C.reduce(comm, xs, root, "sum"))
    # contract: root's copy is the reduction
    return all(float(v[0]) == comm.size
               for v, r in zip(out, comm.ranks) if r == root)


def test_allgather(comm: C.Comms) -> bool:
    xs = _per_rank(comm, lambda r: [float(r)])
    want = np.arange(comm.size, dtype=np.float32)
    return all(np.allclose(v, want)
               for v in _host(C.allgather(comm, xs, tiled=True)))


def test_gather(comm: C.Comms, root: int = 0) -> bool:
    xs = _per_rank(comm, lambda r: [2.0 * r])
    want = np.arange(comm.size, dtype=np.float32) * 2.0
    return all(np.allclose(v, want) for v, r in
               zip(_host(C.gather(comm, xs, root, tiled=True)), comm.ranks)
               if r == root)


def test_reducescatter(comm: C.Comms) -> bool:
    n = comm.size
    # every shard holds the full [0..n) vector; shard i keeps n·i
    xs = _per_rank(comm, lambda r: np.arange(n, dtype=np.float32))
    out = _host(C.reducescatter(comm, xs, "sum"))
    return all(np.allclose(v, [n * r]) for v, r in zip(out, comm.ranks))


def test_sendrecv(comm: C.Comms) -> bool:
    """Ring exchange: shard i sends its value to i + 1
    (test_pointToPoint_simple, comms_test.hpp:215)."""
    n = comm.size
    xs = _per_rank(comm, lambda r: [float(r)])
    out = _host(C.shift(comm, xs, 1))
    return all(np.allclose(v, [float((r - 1) % n)])
               for v, r in zip(out, comm.ranks))


def test_barrier(comm: C.Comms) -> bool:
    return C.barrier(comm) == comm.size


def test_comm_split(comm: C.Comms) -> bool:
    """comm_split (test_commsplit, comms_test.hpp:250): split 2 × (n/2) and
    all-reduce along each sub-axis on its own."""
    n = comm.size
    if n % 2 != 0:
        return True  # not splittable: vacuous, like the reference's skip
    row, col = comm.split(2, n // 2)
    a = np.arange(n, dtype=np.float32).reshape(2, n // 2)
    xs = [torch.tensor([float(g)], device=d)
          for g, d in zip(comm.local, comm.devices)]
    r = _host(C.allreduce(row, xs, "sum"))   # down columns (2 entries)
    c = _host(C.allreduce(col, xs, "sum"))   # across rows (n/2 entries)
    ok = True
    for g, rv, cv in zip(comm.local, r, c):
        i, j = divmod(g, n // 2)
        ok &= bool(np.allclose(rv, a[:, j].sum()))
        ok &= bool(np.allclose(cv, a[i, :].sum()))
    return ok


_ALL_TESTS = {
    "allreduce": test_allreduce,
    "bcast": test_bcast,
    "reduce": test_reduce,
    "allgather": test_allgather,
    "gather": test_gather,
    "reducescatter": test_reducescatter,
    "sendrecv": test_sendrecv,
    "barrier": test_barrier,
    "comm_split": test_comm_split,
}


def comms_self_test(mesh: C.Mesh, axis: str = "data") -> Dict[str, bool]:
    """Every per-collective self-test over ``mesh[axis]`` →
    ``{collective: passed}``, on either transport."""
    comm = C.Comms(mesh, axis)
    return {name: bool(fn(comm)) for name, fn in _ALL_TESTS.items()}
