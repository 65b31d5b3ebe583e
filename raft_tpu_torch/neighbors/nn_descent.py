"""NN-descent ("GNND"), the all-neighbours kNN-graph builder CAGRA can use
(counterpart of ``raft_tpu/neighbors/nn_descent.py``).

The JAX package's formulation, kept as it is: no atomics and no per-thread
queues, everything a batched sort, gather or matmul.

* The graph state is three dense (n, K) tensors (ids, dists, is_new),
  K = ``intermediate_graph_degree``, each row sorted by distance.
* Each round, every node samples up to S "new" and S "old" neighbours from
  its list, and up to S reverse-adjacency sources of those samples.
* The local join gathers each node's sampled union U (4S ids) and computes
  its (4S, 4S) pair distances with one batched matmul per node block.
* Candidate edges (new × new, new × old, both directions) go to their
  target nodes by sort + :func:`~raft_tpu_torch.ops.segment.segment_take`
  and merge with :func:`~raft_tpu_torch.ops.segment.merge_topk_dedup`.
* The host reads one update count per round for the termination test and
  checks the deadline and ``check_interrupt`` before each round.

Random numbers come from one ``torch.Generator`` seeded from
``params.seed``; ``jax.random``'s streams cannot be reproduced, so the
graph is held to the JAX package's by recall, not bit for bit.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from raft_tpu_torch.cluster.kmeans_balanced import seeded_generators
from raft_tpu_torch.core.interruptible import check_interrupt
from raft_tpu_torch.core.logger import get_logger
from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.ops.segment import lexsort2, merge_topk_dedup, segment_take

_log = get_logger()


@dataclass(frozen=True)
class NNDescentParams:
    """The JAX package's ``NNDescentParams`` (nn_descent_types.hpp:49-54)."""

    graph_degree: int = 64
    intermediate_graph_degree: int = 128
    max_iterations: int = 20
    termination_threshold: float = 1e-4
    # per-node sample size; the join costs ~6·sample_size² edges a node
    sample_size: int = 16
    seed: int = 0

    def __post_init__(self):
        if (self.graph_degree <= 0
                or self.intermediate_graph_degree < self.graph_degree):
            raise ValueError(
                "need 0 < graph_degree <= intermediate_graph_degree "
                f"(got {self.graph_degree}, {self.intermediate_graph_degree})")
        if self.sample_size <= 0:
            raise ValueError("sample_size must be positive")


def _pair_indices(s2: int, s4: int, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) index pairs into a node's union U of s4 entries (the first s2
    new, the rest old): new × new unordered pairs and the full new × old
    grid — old × old pairs met in an earlier round."""
    pa, pb = [], []
    for i in range(s2):
        for j in range(i + 1, s4):
            pa.append(i)
            pb.append(j)
    return (torch.tensor(pa, dtype=torch.int64, device=dev),
            torch.tensor(pb, dtype=torch.int64, device=dev))


def _sample(gen, ids, flags, s: int, want_new: bool):
    """Up to ``s`` ids a row whose flag equals ``want_new``, in random
    order → ((n, s) ids, -1 padded; (n, s) their positions, -1 padded)."""
    n, k = ids.shape
    eligible = (flags == want_new) & (ids >= 0)
    r = torch.rand((n, k), generator=gen, device=ids.device)
    order = torch.argsort(torch.where(eligible, r, 2.0 + r), dim=1)[:, :s]
    picked = torch.gather(eligible, 1, order)
    out = torch.where(picked, torch.gather(ids, 1, order),
                      torch.full_like(order, -1).to(ids.dtype))
    return out, torch.where(picked, order, torch.full_like(order, -1))


def _reverse_sample(gen, sample_ids, n: int, s: int):
    """Up to ``s`` reverse-adjacency sources a node from a forward sample:
    edge (i → sample_ids[i, j]) puts i in that node's reverse list, a
    random subset where more than ``s`` arrive."""
    ns, w = sample_ids.shape
    dev = sample_ids.device
    src = torch.arange(ns, dtype=torch.int32,
                       device=dev)[:, None].expand(ns, w).reshape(-1)
    tgt = sample_ids.reshape(-1)
    keys = torch.where(tgt >= 0, tgt, torch.full_like(tgt, n)).to(torch.int32)
    r = torch.rand(keys.shape, generator=gen, device=dev)
    order = lexsort2(r, keys)
    valid, rsrc = segment_take(keys[order], n, s, src[order])
    return torch.where(valid, rsrc, torch.full_like(rsrc, -1))


def _block_pair_dists(X, norms, ids, block_rows: int):
    """d²(i, ids[i, :]) in row blocks (a bounded gather)."""
    n = ids.shape[0]
    out = torch.empty(ids.shape, dtype=torch.float32, device=X.device)
    for s in range(0, n, block_rows):
        bids = ids[s:s + block_rows].clamp(min=0).long()
        xb = X[s:s + block_rows]
        ip = torch.bmm(X[bids], xb[:, :, None])[:, :, 0]
        d = norms[s:s + block_rows, None] + norms[bids] - 2.0 * ip
        out[s:s + block_rows] = torch.clamp(d, min=0.0)
    return torch.where(ids >= 0, out, torch.full_like(out, float("inf")))


def _init_state(gen, X, norms, k: int, block_rows: int):
    """Random initial graph, k draws a node, self edges shifted off and
    duplicates merged away; every entry starts new."""
    n = X.shape[0]
    dev = X.device
    ids = torch.randint(0, n, (n, k), generator=gen, device=dev,
                        dtype=torch.int32)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    ids = torch.where(ids == rows[:, None], (ids + 1) % n, ids)
    dists = _block_pair_dists(X, norms, ids, block_rows)
    ids, dists, _, flags = merge_topk_dedup(
        ids, dists, torch.full((n, 1), -1, dtype=torch.int32, device=dev),
        torch.full((n, 1), float("inf"), device=dev), k, exclude_self=rows,
        payload=torch.ones((n, k), dtype=torch.bool, device=dev),
        cand_payload=torch.zeros((n, 1), dtype=torch.bool, device=dev))
    return ids, dists, flags


def _iteration(gen, X, norms, ids, dists, is_new, k: int, s: int,
               block: int, cand_cap: int):
    """One NN-descent round → (ids, dists, is_new, updates)."""
    n = X.shape[0]
    dev = X.device
    fwd_new, new_pos = _sample(gen, ids, is_new, s, want_new=True)
    fwd_old, _ = _sample(gen, ids, is_new, s, want_new=False)
    rev_new = _reverse_sample(gen, fwd_new, n, s)
    rev_old = _reverse_sample(gen, fwd_old, n, s)
    # sampled new entries join this round: they turn old. An unsampled
    # slot (-1) wraps to the row's last entry, as the JAX package's scatter
    # does (ROADMAP Queue 3)
    rows = torch.arange(n, device=dev)[:, None].expand_as(new_pos)
    is_new = is_new.clone()
    is_new[rows, torch.where(new_pos >= 0, new_pos, k - 1)] = False

    u = torch.cat([fwd_new, rev_new, fwd_old, rev_old], dim=1)   # (n, 4s)
    pa, pb = _pair_indices(2 * s, 4 * s, dev)
    self_rows = torch.arange(n, dtype=torch.int32, device=dev)
    updates = 0
    for b0 in range(0, n, block):
        ub = u[b0:b0 + block]
        us = ub.clamp(min=0).long()
        xu = X[us]                                           # (B, 4s, dim)
        nu = norms[us]
        ip = torch.bmm(xu, xu.transpose(1, 2))
        dd_all = torch.clamp(nu[:, :, None] + nu[:, None, :] - 2.0 * ip,
                             min=0.0)
        a, b = ub[:, pa], ub[:, pb]
        d = dd_all[:, pa, pb]
        ok = (a >= 0) & (b >= 0) & (a != b)
        src = torch.cat([a, b], dim=1).reshape(-1)
        tgt = torch.cat([b, a], dim=1).reshape(-1)
        dd = torch.cat([d, d], dim=1).reshape(-1)
        keys = torch.where(torch.cat([ok, ok], dim=1).reshape(-1), tgt,
                           torch.full_like(tgt, n))
        order = lexsort2(dd, keys)
        valid, csrc, cd = segment_take(keys[order], n, cand_cap, src[order],
                                       dd[order])
        cand_ids = torch.where(valid, csrc, torch.full_like(csrc, -1))
        cand_d = torch.where(valid, cd, torch.full_like(cd, float("inf")))
        ids, dists, from_cand, is_new = merge_topk_dedup(
            ids, dists, cand_ids, cand_d, k, exclude_self=self_rows,
            payload=is_new,
            cand_payload=torch.ones(cand_ids.shape, dtype=torch.bool,
                                    device=dev))
        updates = updates + from_cand.sum()
    return ids, dists, is_new, int(updates)


@traced("nn_descent::build")
def build(dataset, params: NNDescentParams = NNDescentParams(),
          res: Optional[Resources] = None, return_distances: bool = False,
          device: Optional[DeviceLike] = None, stats: Optional[dict] = None):
    """The (n, graph_degree) approximate kNN graph (nn_descent.cuh:59):
    int32 neighbour ids sorted by squared L2 distance, and the distances
    when asked. ``stats``, when given, receives ``iterations``, the
    ``updates`` of each round, the join's node ``block`` and ``init_s`` /
    ``round_s``, host seconds to each round's update count (which waits
    for the device)."""
    res = resources_for(device, res)
    dev = res.device
    X = torch.as_tensor(dataset).to(device=dev, dtype=torch.float32)
    n, dim = X.shape
    if n < 2:
        raise ValueError(f"need at least 2 rows, got {n}")
    k = int(min(params.intermediate_graph_degree, n - 1))
    deg = int(min(params.graph_degree, k))
    s = int(min(params.sample_size, k))
    norms = torch.sum(X * X, dim=1)

    # the join gathers ~(block, 4s, dim) rows and ~12·s² edge triples a
    # node: the workspace bounds both
    per_node = 4 * s * dim * 4 + 12 * s * s * 12
    block = max(256, int(res.workspace_bytes // max(per_node, 1) // 4))
    cand_cap = 2 * s
    (gen,) = seeded_generators(params.seed, 1, dev)
    t0 = time.perf_counter()
    ids, dists, is_new = _init_state(gen, X, norms, k, block_rows=4096)
    init_s = time.perf_counter() - t0

    threshold = params.termination_threshold * n * k
    from raft_tpu_torch.resilience import active_deadline

    rounds, round_s = [], []
    for it in range(params.max_iterations):
        # descent is anytime (each round only improves the graph): a spent
        # budget returns the current graph marked degraded
        dl = active_deadline()
        if dl is not None and it > 0 and dl.reached():
            dl.mark_degraded("nn_descent.build")
            break
        check_interrupt()
        t0 = time.perf_counter()
        ids, dists, is_new, n_updates = _iteration(
            gen, X, norms, ids, dists, is_new, k, s, block, cand_cap)
        round_s.append(time.perf_counter() - t0)
        rounds.append(n_updates)
        _log.debug("nn_descent iter %d: %d updates", it, n_updates)
        if n_updates <= threshold:
            break
    if stats is not None:
        stats.update(iterations=len(rounds), updates=rounds, block=block,
                     init_s=init_s, round_s=round_s)
    if return_distances:
        return ids[:, :deg], dists[:, :deg]
    return ids[:, :deg]
