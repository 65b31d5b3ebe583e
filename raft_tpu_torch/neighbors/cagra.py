"""CAGRA graph index: kNN graph → detour prune → best-first search
(counterpart of ``raft_tpu/neighbors/cagra.py``).

**Build.** A kNN graph of ``intermediate_graph_degree`` (exact brute force
for small n; above ``brute_threshold`` the IVF builder: an IVF-Flat
candidate scan with exact in-list distances while the fp32 dataset fits in
2 GB, IVF-PQ + exact refine above), then :func:`optimize` prunes it to
``graph_degree`` by detour counts and interleaves reverse edges. With the
compression payload on (``compress="auto"`` from 200k rows) every node's
record also inlines its neighbours' vectors as ``p``-dim int8 codes of a
PCA projection (``nbr_codes``), and the IVF centres with their nearest rows
seed the search.

**Search.** A fixed itopk candidate buffer per query, advanced hop by hop:
pick the best ``search_width`` unvisited entries, expand their graph rows,
score, dedup exactly and merge. Three traversals:

* ``"exact"`` — full-precision distances to gathered dataset rows;
* ``"compressed"`` — code-unit distances from the inlined codes (one
  record gather per parent), exact re-rank of the buffer at the end;
* ``"fused"`` — the compressed loop with the whole hop, its parent pickup
  included, in one launch of kernel K6
  (:func:`raft_tpu_torch.ops.cagra_hop.fused_hop`) on a CUDA index; on a
  CPU index the same loop runs the hop's plain twin. ``"auto"``
  takes it when the payload is present and the index lives on a card,
  ``"compressed"`` otherwise. On a card a hop shape K6 cannot take, and a
  fused hop that fails, raise: there is no silent rerun on another loop.

Termination: the host checks the frontier (any unvisited buffer entry) once
per chunk of :data:`_CAGRA_HOP_CHUNK` hops; a hop whose parents are all -1
leaves the buffer as it was, so the hops after a query's frontier closes
change nothing.

Random numbers (the PCA row sample, the fallback k-means, random seeds,
:func:`refine_knn_graph`) come from ``torch.Generator``s seeded from the
params; they are not ``jax.random``'s. Search parity with the JAX package
is therefore held on a JAX-built index carried across
(:func:`from_jax_arrays`, :meth:`CagraIndex.load`), build parity by recall
and invariants.

``filter`` (a :class:`~raft_tpu_torch.core.bitset.Bitset` over the
index's rows) leaves the traversal as it is (filtered-out nodes still
route) and masks the buffer at the finish: before the output top-k of the
exact loop and in the exit re-rank of the compressed and fused ones, as
the JAX package does.

Telemetry and fault injection are the JAX package's: ``cagra::build``
(``cagra.build`` faultpoint first, ``check_interrupt`` before every block
of the kNN-graph and refine sweeps, ``cagra.build.nodes`` and one
``cagra.build.<phase>`` timer a phase), ``cagra::search`` (``cagra.search``
faultpoint, ``check_interrupt`` before every query tile,
``cagra.search.*`` counters), on both compressed traversals a
``cagra::seed`` and a ``cagra::finish`` span around the seeding and the
exit re-rank, and on the fused traversal one ``cagra::hop`` span a chunk
of hops behind the ``cagra.search.hop`` faultpoint, the counters
``cagra.search.hops`` and ``.frontier_checks``, and K6's work counters
``cagra.k6.*`` (:func:`_count_k6`). The JAX package falls back to its
unfused traversal when a fused hop fails; the port does not: a failed K6
launch, or a fault at the hop site, surfaces classified and the search
does not carry on without the kernel.

``build_algo="nn_descent"`` builds the intermediate graph with
:mod:`raft_tpu_torch.neighbors.nn_descent` (degree 1.5·ideg, kept to ideg),
as the JAX package does. The hnsw export is
:mod:`raft_tpu_torch.neighbors.hnsw`; the sharded index is
:mod:`raft_tpu_torch.distributed.cagra`, whose shard bodies resolve their
traversal with ``allow_fused=False``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.obs import roofline as obs_roofline
from raft_tpu_torch.obs.registry import add_device
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.core.interruptible import check_interrupt
from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.core.serialize import load_arrays, save_arrays
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.neighbors import (brute_force, ivf_flat, ivf_pq,
                                      nn_descent, refine)
from raft_tpu_torch.ops.cagra_hop import (fused_hop, hop_shape_error,
                                          occupancy_stats)
from raft_tpu_torch.ops.distance import sqnorm
from raft_tpu_torch.ops.linalg import eig_dc
from raft_tpu_torch.ops.segment import (lexsort2, merge_topk_dedup,
                                        segment_take)
from raft_tpu_torch.ops.select_k import iter_topk_min, iter_topk_min_packed
from raft_tpu_torch.resilience import faultpoint
from raft_tpu_torch.stats.summary import cov

# candidate sets up to this width (width·degree) are deduplicated exactly
# before the select; wider ones take the slack + re-select merge
_CAGRA_DEDUP_LIMIT = 512
# hops between two host checks of the frontier
_CAGRA_HOP_CHUNK = 8
# the JAX package's fused query block; K6 takes one query a warp, so the
# port pads nothing to it and only reports its occupancy_stats
_CAGRA_QBLOCK = 32
_PAYLOAD = ("proj", "code_scale", "nbr_codes", "centroids", "centroid_reps",
            "proj_energy")


@dataclass(frozen=True)
class CagraParams:
    """Build params (the JAX package's, field for field). ``build_algo``:
    "auto" (brute force up to ``brute_threshold`` rows, the IVF builder
    above), "ivf_pq", "nn_descent", "brute".
    ``graph_refine_iters`` -1 = auto: 0 after the IVF-Flat scan, 2 after
    IVF-PQ. ``compress``: the inlined-codes payload, "auto" = from
    ``compress_threshold`` rows; ``compress_dim`` 0 = min(64, dim)."""

    intermediate_graph_degree: int = 128
    graph_degree: int = 64
    build_algo: str = "auto"
    nn_descent_niter: int = 20
    brute_threshold: int = 65536
    ivf_pq_n_lists: int = 0
    ivf_pq_n_probes: int = 0
    ivf_pq_refine_rate: float = 2.0
    graph_refine_iters: int = -1
    graph_refine_sample: int = 448
    compress: str = "auto"
    compress_dim: int = 0
    compress_threshold: int = 200_000
    seed: int = 0

    def __post_init__(self):
        if self.graph_degree <= 0:
            raise ValueError("graph_degree must be positive")
        if self.intermediate_graph_degree < self.graph_degree:
            raise ValueError("intermediate_graph_degree < graph_degree")
        if self.build_algo not in ("auto", "ivf_pq", "nn_descent", "brute"):
            raise ValueError(f"unknown build_algo {self.build_algo!r}")
        if self.compress not in ("auto", "on", "off"):
            raise ValueError(f"unknown compress mode {self.compress!r}")


@dataclass(frozen=True)
class CagraSearchParams:
    """Search params. ``max_iterations`` 0 = max(16, itopk // width).
    ``traversal``: "auto" | "fused" | "compressed" | "exact".
    ``refine_topk``: exact re-rank depth of the compressed traversals
    (0 = the whole buffer)."""

    itopk_size: int = 64
    max_iterations: int = 0
    min_iterations: int = 0
    search_width: int = 1
    num_random_samplings: int = 1
    traversal: str = "auto"
    refine_topk: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.itopk_size <= 0 or self.search_width <= 0:
            raise ValueError("itopk_size and search_width must be positive")
        if self.traversal not in ("auto", "fused", "compressed", "exact"):
            raise ValueError(f"unknown traversal mode {self.traversal!r}")


@dataclass
class CagraIndex:
    """Dataset + fixed-degree graph, and optionally the compressed-traversal
    payload: ``proj`` (dim, p) and ``code_scale`` () of the int8 codes,
    ``nbr_codes`` (n, graph_degree, p) int8 (node i's record inlines its
    neighbours' codes), ``centroids`` (c, dim) with ``centroid_reps`` (c,)
    for guided seeding, ``proj_energy`` () the variance share the
    projection keeps."""

    dataset: torch.Tensor              # (n, dim) fp32, or uint8/int8
    graph: torch.Tensor                # (n, graph_degree) int32
    norms: torch.Tensor                # (n,) fp32 squared norms
    proj: Optional[torch.Tensor] = None
    code_scale: Optional[torch.Tensor] = None
    nbr_codes: Optional[torch.Tensor] = None
    centroids: Optional[torch.Tensor] = None
    centroid_reps: Optional[torch.Tensor] = None
    proj_energy: Optional[torch.Tensor] = None
    build_timings_s: Dict[str, float] = field(default_factory=dict,
                                              repr=False)

    @property
    def size(self) -> int:
        return self.dataset.shape[0]

    @property
    def dim(self) -> int:
        return self.dataset.shape[1]

    @property
    def graph_degree(self) -> int:
        return self.graph.shape[1]

    @property
    def device(self) -> torch.device:
        return self.graph.device

    def arrays(self) -> Dict[str, torch.Tensor]:
        out = {"dataset": self.dataset, "graph": self.graph,
               "norms": self.norms}
        for name in _PAYLOAD:
            if getattr(self, name) is not None:
                out[name] = getattr(self, name)
        return out

    def to(self, device: DeviceLike) -> "CagraIndex":
        """A copy of the index with its tensors on ``device``."""
        dev = torch.device(device)
        return CagraIndex(**{name: t.to(dev)
                             for name, t in self.arrays().items()})

    def save(self, path) -> None:
        """Write the v2 container both packages read (kind ``cagra``)."""
        save_arrays(path, {"kind": "cagra", "metric": "sqeuclidean"},
                    self.arrays())

    @classmethod
    def load(cls, path, device: Optional[DeviceLike] = None,
             res: Optional[Resources] = None) -> "CagraIndex":
        """Read a ``cagra`` container written by either package."""
        meta, arrays = load_arrays(path)
        return from_jax_arrays(meta, arrays, device=device, res=res)


def from_jax_arrays(meta: Mapping[str, Any], arrays: Mapping[str, Any],
                    device: Optional[DeviceLike] = None,
                    res: Optional[Resources] = None) -> CagraIndex:
    """An index from the JAX package's arrays (``dataset``, ``graph``,
    ``norms`` and any of the payload arrays, as numpy or anything
    ``np.asarray`` takes) and its container meta."""
    if meta.get("kind", "cagra") != "cagra":
        raise ValueError(f"not a cagra index: {meta.get('kind')}")
    dev = resources_for(device, res).device

    def t(name):
        return torch.from_numpy(np.array(arrays[name])).to(dev)

    opt = {name: t(name) for name in _PAYLOAD
           if arrays.get(name) is not None}
    return CagraIndex(t("dataset"), t("graph"), t("norms"), **opt)


# ---------------------------------------------------------------------------
# Build: kNN graph + optimize (prune)
# ---------------------------------------------------------------------------


def _detour_counts(graph: torch.Tensor, gb: torch.Tensor) -> torch.Tensor:
    """(B, K) detour counts of a node block: for target t = gb[:, j], the
    number of (i, m) with i < j and m < j and graph[gb[:, i], m] == t (an
    invalid gb[:, i] reads row 0, as the JAX package's clamped gather).
    Each node's K² two-hop ids, keyed ``id·K + max(i, m)``, are sorted
    once; a count is then the number of keys in ``[t·K, t·K + j)``."""
    n, K = graph.shape
    dev = graph.device
    two_hop = graph[torch.clamp(gb, min=0).long()]             # (B, K, K)
    kt = torch.int64 if n * K > (1 << 31) - 1 else torch.int32
    ar = torch.arange(K, device=dev, dtype=kt)
    maxim = torch.maximum(ar[:, None], ar[None, :])
    keys = (two_hop.to(kt) * K + maxim).reshape(gb.shape[0], K * K)
    keys = torch.sort(keys, dim=1).values
    base = gb.to(kt) * K
    lo = torch.searchsorted(keys, base.contiguous())
    hi = torch.searchsorted(keys, (base + ar[None, :]).contiguous())
    return (hi - lo).to(torch.int32)


def optimize(graph: torch.Tensor, out_degree: int,
             n_blocks: int = 1) -> torch.Tensor:
    """Prune an intermediate kNN graph to ``out_degree`` — bit for bit the
    JAX package's ``optimize``.

    1. Detour counts: edge (s→t) at rank j is detourable through u at rank
       i < j when t is in u's list at rank m < j; keep the ``out_degree``
       edges with the fewest detours (rank breaks ties; -1 entries last).
       The counts are integers, so any exact algorithm gives the same
       graph: this one sorts each node's two-hop ids once
       (:func:`_detour_counts`), in ``n_blocks`` node blocks.
    2. Reverse edges: the final list interleaves the best half of the
       pruned forward edges with up to ``out_degree / 2`` reverse edges
       (better-ranked sources first), then the rest of the forward edges,
       deduplicated, without self edges.
    """
    n, K = graph.shape
    dev = graph.device
    block = -(-n // max(1, int(n_blocks)))
    counts = torch.cat([_detour_counts(graph, graph[s:s + block])
                        for s in range(0, n, block)], dim=0)
    rank = torch.arange(K, dtype=torch.int32, device=dev)[None, :]
    key = torch.where(graph >= 0, counts * K + rank,
                      torch.full_like(counts, torch.iinfo(torch.int32).max))
    order = torch.sort(key, dim=1, stable=True).indices[:, :out_degree]
    fwd = torch.gather(graph, 1, order)                        # (n, out)

    half = max(1, out_degree // 2)
    src = torch.arange(n, dtype=torch.int32, device=dev)[:, None].expand(
        fwd.shape).reshape(-1)
    tgt = fwd.reshape(-1)
    rnk = torch.arange(out_degree, dtype=torch.int64, device=dev)[None, :] \
        .expand(fwd.shape).reshape(-1)
    keys = torch.where(tgt >= 0, tgt, torch.full_like(tgt, n)).to(torch.int32)
    # lexsort((rnk, keys)): target first, then rank, then source position
    order = torch.sort(keys.to(torch.int64) * out_degree + rnk,
                       stable=True).indices
    valid, rev = segment_take(keys[order], n, half, src[order])
    rev = torch.where(valid, rev, torch.full_like(rev, -1))

    inf = float("inf")
    ar = torch.arange(out_degree, dtype=torch.int32, device=dev)
    prio_fwd = torch.where(ar < half, ar, ar + 2 * half).to(torch.float32)
    prio_fwd = torch.where(fwd >= 0, prio_fwd[None, :].expand(fwd.shape),
                           torch.full(fwd.shape, inf, device=dev))
    prio_rev = (torch.arange(half, dtype=torch.int32, device=dev)
                + half).to(torch.float32)
    prio_rev = torch.where(rev >= 0, prio_rev[None, :].expand(rev.shape),
                           torch.full(rev.shape, inf, device=dev))
    out_ids, _, _ = merge_topk_dedup(
        fwd, prio_fwd, rev, prio_rev, out_degree,
        exclude_self=torch.arange(n, dtype=torch.int32, device=dev))
    return out_ids


def _drop_self(ids: torch.Tensor, row_start: int, ideg: int) -> torch.Tensor:
    """Remove each row's self-match and compact to ``ideg`` columns
    (stable)."""
    rows = row_start + torch.arange(ids.shape[0], dtype=torch.int32,
                                    device=ids.device)
    ids = torch.where(ids == rows[:, None], torch.full_like(ids, -1), ids)
    order = torch.sort(torch.where(ids < 0, 2, 0), dim=1,
                       stable=True).indices[:, :ideg]
    return torch.gather(ids, 1, order)


def _flat_builder_fits(n: int, dim: int) -> bool:
    """The IVF-Flat candidate scan (exact distances, no refine) while the
    raw fp32 dataset stays ≤ 2 GB; IVF-PQ + refine above. One predicate
    for the builder choice and the auto graph-refine sweeps."""
    return n * dim * 4 <= (2 << 30)


def _sync(dev: torch.device) -> None:
    """Wait for the card, so a phase's time is its completion time."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _build_knn_ivf_pq(X: torch.Tensor, ideg: int, params: CagraParams,
                      res: Resources):
    """Intermediate kNN graph from an IVF candidate search over the dataset
    itself → (graph (n, ideg) int32, coarse centres). While the fp32
    dataset fits 2 GB: IVF-Flat with exact in-list distances at
    ``kf = ideg + 1`` (the slot the self-match takes), every batch one
    strip search through kernel K1 (named, so the CPU runs K1's twin where
    ``"auto"`` would pick the gather backend); above it IVF-PQ with exact
    refine."""
    n, dim = X.shape
    n_lists = params.ivf_pq_n_lists or int(
        max(16, min(65536, round((n / 976) ** 0.5) ** 2, n // 64)))
    n_probes = params.ivf_pq_n_probes or max(8, n_lists // 16)
    frac = float(min(1.0, max(0.1, 200_000 / n)))
    out = []
    if _flat_builder_fits(n, dim):
        kf = ideg + 1
        idx = ivf_flat.build(X, ivf_flat.IvfFlatParams(
            n_lists=n_lists, kmeans_trainset_fraction=frac, group_size=512,
            seed=params.seed), res=res)
        B = int(max(4096, min(n, res.workspace_bytes
                              // max(kf * (dim + 8) * 4, 1))))
        for s in range(0, n, B):
            check_interrupt()
            _, ids = ivf_flat.search(idx, X[s:s + B], kf, n_probes=n_probes,
                                     backend="ragged", res=res)
            out.append(_drop_self(ids, s, ideg))
    else:
        kf = int(min(max(ideg + 2,
                         round(params.ivf_pq_refine_rate * (ideg + 1))), 512))
        idx = ivf_pq.build(X, ivf_pq.IvfPqParams(
            n_lists=n_lists, pq_dim=max(8, dim // 2), pq_bits=8,
            kmeans_trainset_fraction=frac, seed=params.seed), res=res)
        B = int(max(4096, min(n, res.workspace_bytes
                              // max(kf * (dim + 8) * 4, 1))))
        for s in range(0, n, B):
            check_interrupt()
            qb = X[s:s + B]
            _, cand = ivf_pq.search(idx, qb, kf, n_probes=n_probes, res=res)
            _, ids = refine.refine(X, qb, cand, min(ideg + 1, kf), res=res)
            out.append(_drop_self(ids, s, ideg))
    return torch.cat(out, dim=0), idx.centers


def _refine_graph_block(X: torch.Tensor, graph: torch.Tensor, start: int,
                        pick: torch.Tensor) -> torch.Tensor:
    """One node block of the neighbour-of-neighbour sweep: candidates =
    own list + the two-hop ids at ``pick`` (block, sample), exact
    distances, dedup, keep the best ideg."""
    n = X.shape[0]
    ideg = graph.shape[1]
    block = pick.shape[0]
    dev = X.device
    rows = start + torch.arange(block, dtype=torch.int32, device=dev)
    rows_c = torch.clamp(rows, max=n - 1).long()
    own = graph[rows_c]
    two_hop = graph[torch.clamp(own, min=0).long()].reshape(block, ideg * ideg)
    cands = torch.cat([own, torch.gather(two_hop, 1, pick)], dim=1)
    cands = torch.where(cands == rows[:, None], torch.full_like(cands, -1),
                        cands)
    xv = X[torch.clamp(cands, min=0).long()].to(torch.float32)
    qv = X[rows_c].to(torch.float32)
    d = torch.sum(xv * xv, dim=2) - 2.0 * torch.bmm(xv, qv[:, :, None])[:, :, 0]
    inf = torch.full_like(d, float("inf"))
    d = torch.where(cands >= 0, d, inf)
    # id-primary sort: every copy of an id is adjacent, its best first
    order = lexsort2(d, cands)
    si = torch.gather(cands, 1, order)
    sd = torch.gather(d, 1, order)
    dup = torch.cat([torch.zeros((block, 1), dtype=torch.bool, device=dev),
                     si[:, 1:] == si[:, :-1]], dim=1)
    sd = torch.where(dup | (si < 0), inf, sd)
    order2 = torch.sort(sd, dim=1, stable=True).indices[:, :ideg]
    out = torch.gather(si, 1, order2)
    keep = torch.gather(sd, 1, order2) < float("inf")
    return torch.where(keep, out, torch.full_like(out, -1))


def refine_knn_graph(X: torch.Tensor, graph: torch.Tensor, iters: int,
                     sample: int, seed: int, res: Resources) -> torch.Tensor:
    """NN-descent-style refinement of an intermediate kNN graph: ``iters``
    sweeps over node blocks, each keeping the best ideg of a node's list
    and ``sample`` random two-hop neighbours (exact distances)."""
    n, dim = X.shape
    ideg = graph.shape[1]
    width = ideg + sample
    block = int(max(1024, min(n, res.workspace_bytes
                              // max(width * (dim + 4) * 4, 1))))
    (gen,) = kmeans_balanced.seeded_generators(seed ^ 0x5EED, 1, X.device)
    for _ in range(iters):
        parts = []
        for s in range(0, n, block):
            check_interrupt()
            pick = torch.randint(0, ideg * ideg, (block, int(sample)),
                                 generator=gen, device=X.device)
            parts.append(_refine_graph_block(X, graph, s, pick)[:n - s])
        graph = torch.cat(parts, dim=0)
    return graph


@traced("cagra::build")
def build(dataset, params: CagraParams = CagraParams(),
          res: Optional[Resources] = None,
          device: Optional[DeviceLike] = None) -> CagraIndex:
    """Build a CAGRA index: kNN graph (brute force, or the IVF builder),
    optional refine sweeps, :func:`optimize` to ``graph_degree``, and the
    compression payload. Integer datasets are stored in their own dtype.
    Each phase's wall seconds, measured to completion on the card, are in
    ``index.build_timings_s`` (``knn_graph``, ``refine_sweeps``,
    ``optimize``, ``compress``)."""
    faultpoint("cagra.build")
    res = resources_for(device, res)
    dev = res.device
    data = torch.as_tensor(dataset).to(dev)
    X = data.to(torch.float32)
    n, dim = X.shape
    ideg = int(min(params.intermediate_graph_degree, n - 1))
    deg = int(min(params.graph_degree, ideg))
    algo = params.build_algo
    if algo == "auto":
        algo = "brute" if n <= params.brute_threshold else "ivf_pq"

    timings = {}
    t0 = time.perf_counter()
    centroids = None
    if algo == "brute" or n <= 2048:
        _, ids = brute_force.knn(X, X, ideg + 1, res=res)
        graph = _drop_self(ids, 0, ideg)
        _sync(dev)
        timings["knn_graph"] = time.perf_counter() - t0
    elif algo == "ivf_pq":
        graph, centroids = _build_knn_ivf_pq(X, ideg, params, res)
        _sync(dev)
        timings["knn_graph"] = time.perf_counter() - t0
        sweeps = params.graph_refine_iters
        if sweeps < 0:
            sweeps = 0 if _flat_builder_fits(n, dim) else 2
        if sweeps > 0:
            t0 = time.perf_counter()
            graph = refine_knn_graph(X, graph, int(sweeps),
                                     int(params.graph_refine_sample),
                                     params.seed, res)
            _sync(dev)
            timings["refine_sweeps"] = time.perf_counter() - t0
    else:
        graph = nn_descent.build(X, nn_descent.NNDescentParams(
            graph_degree=ideg,
            intermediate_graph_degree=min(int(1.5 * ideg), n - 1),
            max_iterations=params.nn_descent_niter, seed=params.seed),
            res=res)
        _sync(dev)
        timings["knn_graph"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    per_node = ideg * ideg * 4 * 2
    block = max(128, int(res.workspace_bytes // max(per_node, 1) // 2))
    pruned = optimize(graph, deg, n_blocks=max(1, -(-n // block)))
    norms = sqnorm(X)
    _sync(dev)
    timings["optimize"] = time.perf_counter() - t0
    store = data if not data.is_floating_point() else X
    out = CagraIndex(store, pruned, norms)
    compress = params.compress == "on" or (
        params.compress == "auto" and n >= params.compress_threshold)
    if compress:
        t0 = time.perf_counter()
        out = _attach_compression(out, X, params, centroids, res)
        _sync(dev)
        timings["compress"] = time.perf_counter() - t0
    out.build_timings_s = timings
    if obs.enabled():
        obs.add("cagra.build.nodes", n)
        for phase, secs in timings.items():
            obs.record_timing(f"cagra.build.{phase}", secs)
    return out


def _attach_compression(index: CagraIndex, X: torch.Tensor,
                        params: CagraParams, centroids,
                        res: Resources) -> CagraIndex:
    """The compressed-traversal payload: a PCA projection to ``p`` dims
    (an orthonormal basis when p == dim), the seeding table (the builder's
    centres, or a quick balanced k-means, with each centre's nearest row),
    and every node's neighbours' int8 codes inlined in its record."""
    n, dim = X.shape
    dev = X.device
    p = min(int(params.compress_dim) or min(64, dim), dim)
    (gen,) = kmeans_balanced.seeded_generators(params.seed ^ 0xC0DE, 1, dev)
    if p < dim:
        m = min(n, 262_144)
        rows = (torch.randint(0, n, (m,), generator=gen, device=dev)
                if m < n else torch.arange(n, device=dev))
        vals, vecs = eig_dc(cov(X[rows], sample=False))  # ascending
        proj = vecs.flip(1)[:, :p].contiguous()
        energy = torch.sum(vals[-p:]) / torch.clamp(torch.sum(vals),
                                                    min=1e-30)
    else:
        g = torch.randn((dim, p), generator=gen, device=dev)
        proj, _ = torch.linalg.qr(g)
        energy = torch.tensor(1.0, device=dev)
    # the seeding table first: its brute-force pass and the code payload
    # do not need device memory at the same time
    reps = None
    if centroids is None and n > 4 * 1024:
        c = int(max(16, min(1024, n // 256)))
        frac = float(min(1.0, max(0.05, 100_000 / n)))
        (gen_km,) = kmeans_balanced.seeded_generators(params.seed ^ 0x5EED5,
                                                      1, dev)
        train = (X[torch.randint(0, n, (int(frac * n),), generator=gen_km,
                                 device=dev)] if frac < 1.0 else X)
        centroids = kmeans_balanced.fit(
            train, c, kmeans_balanced.KMeansBalancedParams(), res=res)
    if centroids is not None:
        _, rep_ids = brute_force.knn(centroids, X, 1, res=res)
        reps = rep_ids[:, 0].to(torch.int32)

    xp = X @ proj
    scale = torch.clamp(torch.max(torch.abs(xp)) / 127.0, min=1e-12)
    codes = torch.clamp(torch.round(xp / scale), -127, 127).to(torch.int8)
    del xp
    deg = index.graph_degree
    nbr_codes = torch.empty((n, deg, p), dtype=torch.int8, device=dev)
    blk = int(max(65536, res.workspace_bytes // max(deg * p * 2, 1)))
    for s in range(0, n, blk):
        gb = index.graph[s:s + blk]
        nc = codes[torch.clamp(gb, min=0).long()]
        nbr_codes[s:s + blk] = torch.where(gb[..., None] >= 0, nc,
                                           torch.zeros_like(nc))
    return CagraIndex(index.dataset, index.graph, index.norms, proj=proj,
                      code_scale=scale, nbr_codes=nbr_codes,
                      centroids=centroids, centroid_reps=reps,
                      proj_energy=energy)


@traced("cagra::build_from_graph")
def build_from_graph(dataset, graph, res: Optional[Resources] = None,
                     device: Optional[DeviceLike] = None) -> CagraIndex:
    """Wrap a prebuilt kNN graph (the interop path)."""
    dev = resources_for(device, res).device
    X = torch.as_tensor(dataset).to(dev).to(torch.float32)
    return CagraIndex(X, torch.as_tensor(graph).to(dev).to(torch.int32),
                      sqnorm(X))


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


def _merge_candidates(bids, bd, bvis, cids, cd, itopk: int, packed: bool,
                      dedup_limit: int):
    """Buffer ∪ candidates → new (ids, d, vis), the merge every traversal
    shares. Up to ``dedup_limit`` candidates, candidate duplicates are
    masked exactly before the select; wider sets select itopk + slack, mask
    later copies among the survivors and select again. ``packed`` picks the
    mantissa-packed select over a stable ascending one; both keep the first
    copy (the buffer's, with its visited flag)."""
    inf = float("inf")
    dup_buf = (cids[:, :, None] == bids[:, None, :]).any(dim=2)
    bb = cids.shape[1]
    if bb <= dedup_limit:
        tri = torch.tril(torch.ones((bb, bb), dtype=torch.bool,
                                    device=cids.device), diagonal=-1)
        dup_self = ((cids[:, :, None] == cids[:, None, :]) & tri).any(dim=2)
        cd = torch.where(dup_buf | dup_self | (cids < 0),
                         torch.full_like(cd, inf), cd)
        slack = 0
    else:
        cd = torch.where(dup_buf | (cids < 0), torch.full_like(cd, inf), cd)
        slack = min(bb, max(8, itopk // 4))
    allv = torch.cat([bd, cd], dim=1)
    alli = torch.cat([bids, cids], dim=1)
    allvis = torch.cat([bvis, torch.zeros(cids.shape, dtype=bvis.dtype,
                                          device=bvis.device)], dim=1)
    select = iter_topk_min_packed if packed else iter_topk_min
    nv, sel = select(allv, itopk + slack)
    sel = sel.long()
    ni = torch.gather(alli, 1, sel)
    nvis = torch.gather(allvis, 1, sel)
    if slack:
        w2 = itopk + slack
        ar = torch.arange(w2, device=cids.device)
        dup = ((ni[:, :, None] == ni[:, None, :])
               & (ar[None, None, :] < ar[None, :, None])).any(dim=2)
        nv = torch.where(dup, torch.full_like(nv, inf), nv)
        nv, sel2 = select(nv, itopk)
        sel2 = sel2.long()
        ni = torch.gather(ni, 1, sel2)
        nvis = torch.gather(nvis, 1, sel2)
    ni = torch.where(torch.isinf(nv), torch.full_like(ni, -1), ni)
    return ni, nv, nvis


def _empty_buffer(q: int, itopk: int, dev, vis_dtype=torch.bool):
    return (torch.full((q, itopk), -1, dtype=torch.int32, device=dev),
            torch.full((q, itopk), float("inf"), device=dev),
            torch.ones((q, itopk), dtype=vis_dtype, device=dev))


def _traverse(state, hop_chunk, max_iter: int, min_iter: int):
    """Advance ``(ids, d, vis)`` by ``hop_chunk(state, hops)`` in chunks of
    :data:`_CAGRA_HOP_CHUNK` hops until no buffer has an unvisited entry
    (checked on the host before each chunk) or ``max_iter`` hops, and at
    least ``min_iter``. → (state, hops run, host reads of the frontier)."""
    it = checks = 0
    while it < max_iter:
        ids, _, vis = state
        if it >= min_iter:
            checks += 1
            if not bool(((vis == 0) & (ids >= 0)).any()):
                break
        hops = min(_CAGRA_HOP_CHUNK, max_iter - it)
        state = hop_chunk(state, hops)
        it += hops
    return state, it, checks


def _repeat(hop):
    """A chunk of ``hops`` applications of a one-hop function."""
    def chunk(state, hops):
        for _ in range(hops):
            state = hop(state)
        return state
    return chunk


def _search_impl(dataset, graph, queries, gen, k: int, itopk: int,
                 width: int, max_iter: int, min_iter: int, n_rand: int,
                 filter=None):
    """The exact traversal: random seeds, full-precision distances to the
    gathered rows, the stable merge; ``filter`` masks the buffer before the
    output top-k. → (d, ids, hops)."""
    n = dataset.shape[0]
    q = queries.shape[0]
    deg = graph.shape[1]
    b = width * deg
    dev = queries.device
    qf = queries.to(torch.float32)
    inf = float("inf")

    def batch_dists(ids):
        """‖x‖² − 2⟨q, x⟩ (‖q‖² is added at the end)."""
        xv = dataset[torch.clamp(ids, min=0).long()].to(torch.float32)
        ip = torch.bmm(xv, qf[:, :, None])[:, :, 0]
        d = torch.sum(xv * xv, dim=2) - 2.0 * ip
        return torch.where(ids >= 0, d, torch.full_like(d, inf))

    def merge(bids, bd, bvis, cids, cd):
        return _merge_candidates(bids, bd, bvis, cids, cd, itopk,
                                 packed=False, dedup_limit=320)

    n_seed = min(itopk * n_rand, n)
    seed_ids = torch.randint(0, n, (q, n_seed), generator=gen, device=dev,
                             dtype=torch.int32)
    state = merge(*_empty_buffer(q, itopk, dev), seed_ids,
                  batch_dists(seed_ids))

    def hop(state):
        ids_b, d_b, vis = state
        pkey = torch.where(vis | (ids_b < 0), torch.full_like(d_b, inf), d_b)
        _, ppos = iter_topk_min(pkey, width)
        ppos = ppos.long()
        parent_ids = torch.gather(ids_b, 1, ppos)
        parent_ok = torch.gather(pkey, 1, ppos) < inf
        vis = vis.scatter(1, ppos, True)
        gr = graph[torch.clamp(parent_ids, min=0).long()]
        nbrs = torch.where(parent_ok[:, :, None] & (gr >= 0), gr,
                           torch.full_like(gr, -1)).reshape(q, b)
        return merge(ids_b, d_b, vis, nbrs, batch_dists(nbrs))

    (buf_ids, buf_d, _), hops, _ = _traverse(state, _repeat(hop), max_iter,
                                              min_iter)
    if filter is not None:
        buf_d = torch.where(filter.test(buf_ids), buf_d, inf)
    out_d, sel = iter_topk_min(buf_d, k)
    out_ids = torch.gather(buf_ids, 1, sel.long())
    qn = torch.sum(qf * qf, dim=1)
    out_ids = torch.where(torch.isinf(out_d), torch.full_like(out_ids, -1),
                          out_ids)
    out_d = torch.where(torch.isinf(out_d), torch.full_like(out_d, inf),
                        torch.clamp(out_d + qn[:, None], min=0.0))
    return out_d, out_ids, hops


def _seed_compressed(index: CagraIndex, qf, qp, gen, itopk: int, n_rand: int,
                     merge, vis_dtype=torch.bool):
    """Seed the compressed buffer (one implementation for the unfused and
    the fused loop): centroid-guided when the payload has a seeding table
    (centre distances scaled into code units by the projection's energy),
    random rows projected on the fly otherwise."""
    dataset, proj, code_scale = index.dataset, index.proj, index.code_scale
    n, dim = dataset.shape
    p = proj.shape[1]
    q = qf.shape[0]
    dev = qf.device
    if index.centroids is not None:
        cen = index.centroids
        cd_full = (torch.sum(cen * cen, dim=1)[None, :]
                   - (2.0 * qf) @ cen.T)              # + ‖q‖², dropped
        n_seed = min(itopk, cen.shape[0])
        s2 = code_scale * code_scale
        qp_n = torch.sum(qp * qp, dim=1)
        frac = (index.proj_energy if index.proj_energy is not None
                else torch.tensor(p / dim, dtype=torch.float32, device=dev))
        cd_code = (cd_full * frac) / s2 + (
            torch.sum(qf * qf, dim=1) * frac / s2 - qp_n)[:, None]
        seed_d, spos = iter_topk_min_packed(cd_code, n_seed)
        seed_ids = index.centroid_reps[spos.long()].to(torch.int32)
    else:
        n_seed = min(itopk * n_rand, n)
        seed_ids = torch.randint(0, n, (q, n_seed), generator=gen,
                                 device=dev, dtype=torch.int32)
        xv = dataset[seed_ids.long()].to(torch.float32)
        xp = torch.matmul(xv, proj) / code_scale
        seed_d = torch.sum(xp * xp, dim=2) - 2.0 * torch.bmm(
            xp, qp[:, :, None])[:, :, 0]
    return merge(*_empty_buffer(q, itopk, dev, vis_dtype), seed_ids, seed_d)


def _exact_rerank(dataset, qf, buf_ids, k: int, rt: int, filter=None):
    """Exact re-rank of the buffer head (its best ``rt`` entries) against
    the raw dataset, the exit both compressed traversals share; ids that
    fail ``filter`` are masked."""
    inf = float("inf")
    r_ids = buf_ids[:, :rt]
    xv = dataset[torch.clamp(r_ids, min=0).long()].to(torch.float32)
    ip = torch.bmm(xv, qf[:, :, None])[:, :, 0]
    d_exact = torch.sum(xv * xv, dim=2) - 2.0 * ip
    d_exact = torch.where(r_ids >= 0, d_exact, torch.full_like(d_exact, inf))
    if filter is not None:
        d_exact = torch.where(filter.test(r_ids), d_exact, inf)
    out_d, sel = iter_topk_min(d_exact, k)
    out_ids = torch.gather(r_ids, 1, sel.long())
    qn = torch.sum(qf * qf, dim=1)
    out_ids = torch.where(torch.isinf(out_d), torch.full_like(out_ids, -1),
                          out_ids)
    out_d = torch.where(torch.isinf(out_d), torch.full_like(out_d, inf),
                        torch.clamp(out_d + qn[:, None], min=0.0))
    return out_d, out_ids


def _code_merge(itopk: int):
    def merge(bids, bd, bvis, cids, cd):
        return _merge_candidates(bids, bd, bvis, cids, cd, itopk, packed=True,
                                 dedup_limit=_CAGRA_DEDUP_LIMIT)
    return merge


def _search_impl_compressed(index: CagraIndex, queries, gen, k: int,
                            itopk: int, width: int, max_iter: int,
                            min_iter: int, n_rand: int, refine_topk: int,
                            filter=None):
    """The unfused traversal over inlined codes: per hop, q·w graph-row and
    code-record gathers, a (q, w·deg, p) int8 × bf16 contraction, the
    exact (or slack) dedup and the packed itopk select; the exit re-ranks
    the buffer head exactly. → (d, ids, hops)."""
    graph, nbr_codes = index.graph, index.nbr_codes
    q = queries.shape[0]
    deg = graph.shape[1]
    p = index.proj.shape[1]
    b = width * deg
    inf = float("inf")
    qf = queries.to(torch.float32)
    qp = (qf @ index.proj) / index.code_scale
    qb = qp.to(torch.bfloat16).to(torch.float32)[:, :, None]

    def code_dists(codes, ids):
        cf = codes.to(torch.float32)        # int8 is exact in bf16
        d = torch.sum(cf * cf, dim=2) - 2.0 * torch.bmm(cf, qb)[:, :, 0]
        return torch.where(ids >= 0, d, torch.full_like(d, inf))

    merge = _code_merge(itopk)
    with obs.record_span("cagra::seed"):
        state = _seed_compressed(index, qf, qp, gen, itopk, n_rand, merge)

    def hop(state):
        ids_b, d_b, vis = state
        pkey = torch.where(vis | (ids_b < 0), torch.full_like(d_b, inf), d_b)
        pv, ppos = iter_topk_min_packed(pkey, width)
        ppos = ppos.long()
        parent_ids = torch.gather(ids_b, 1, ppos)
        parent_ok = ~torch.isinf(pv)
        vis = vis.scatter(1, ppos, True)
        pid_c = torch.clamp(parent_ids, min=0).long()
        gr = graph[pid_c]                          # (q, w, deg)
        codes = nbr_codes[pid_c].reshape(q, b, p)  # (q, w·deg, p)
        nbrs = torch.where(parent_ok[:, :, None] & (gr >= 0), gr,
                           torch.full_like(gr, -1)).reshape(q, b)
        return merge(ids_b, d_b, vis, nbrs, code_dists(codes, nbrs))

    (buf_ids, _, _), hops, _ = _traverse(state, _repeat(hop), max_iter,
                                         min_iter)
    with obs.record_span("cagra::finish"):
        out_d, out_ids = _exact_rerank(index.dataset, qf, buf_ids, k,
                                       refine_topk, filter)
    return out_d, out_ids, hops


def _fused_init(index: CagraIndex, queries, gen, itopk: int, n_rand: int):
    """Queries into code units and the seeded buffer — the unfused loop's
    preamble, with the visited flags as fp32 for the kernel."""
    qf = queries.to(torch.float32)
    qp = ((qf @ index.proj) / index.code_scale).contiguous()
    buf_ids, buf_d, buf_vis = _seed_compressed(
        index, qf, qp, gen, itopk, n_rand, _code_merge(itopk),
        vis_dtype=torch.float32)
    return buf_ids, buf_d, buf_vis, qp


def _count_k6(started, width: int) -> None:
    """K6's work counters over the ``(ids, vis)`` buffers its launches
    started from: ``cagra.k6.launches``, ``cagra.k6.parents_launched``
    (rows × the hop's parents) and, summed on the card,
    ``cagra.k6.parents_live`` (a row's unvisited live entries, at most the
    hop's parents: the parents that expand a real node)."""
    ids = torch.stack([i for i, _ in started])
    vis = torch.stack([v for _, v in started])
    w = min(int(width), ids.shape[-1])
    live = ((vis == 0) & (ids >= 0)).sum(-1).clamp(max=w).sum()
    obs.add("cagra.k6.launches", len(started))
    obs.add("cagra.k6.parents_launched", ids.shape[0] * ids.shape[1] * w)
    add_device("cagra.k6.parents_live", live)


def _fused_hop_chunk(index: CagraIndex, qp, state, width: int, hops: int,
                     started=None):
    """``hops`` hops of the fused loop, each one :func:`fused_hop` that
    picks its own ``width`` parents (one launch of K6 on a card, and no
    torch op beside it), behind the ``cagra.search.hop`` faultpoint and in
    one ``cagra::hop`` span. ``started`` (a list, with telemetry on)
    collects the ``(ids, vis)`` each launch starts from, which
    :func:`_count_k6` counts once after the traversal, so the spans hold
    K6's launches alone."""
    faultpoint("cagra.search.hop")
    with obs.record_span("cagra::hop",
                         attrs=({"hops": hops, "width": width}
                                if obs.enabled() else None)):
        for _ in range(hops):
            if started is not None:
                started.append((state[0], state[2]))
            state = fused_hop(*state, None, qp, index.graph, index.nbr_codes,
                              width=width)
    return state


def _fused_finish(index: CagraIndex, queries, buf_ids, k: int, rt: int,
                  filter=None):
    return _exact_rerank(index.dataset, queries.to(torch.float32), buf_ids,
                         k, rt, filter)


def _run_fused_tile(index: CagraIndex, qs, gen, k: int, itopk: int,
                    width: int, max_iter: int, min_iter: int, n_rand: int,
                    rt: int, filter=None):
    """One query tile through the fused traversal: init, hops in chunks,
    exact exit re-rank, the first and the last in the ``cagra::seed`` and
    ``cagra::finish`` spans. Telemetry counts the hops run
    (``cagra.search.hops``, which the JAX package counts on its fused loop
    alone) and the host's reads of the frontier
    (``cagra.search.frontier_checks``). → (d, ids, hops)."""
    with obs.record_span("cagra::seed"):
        buf_ids, buf_d, buf_vis, qp = _fused_init(index, qs, gen, itopk,
                                                  n_rand)
    started = [] if obs.enabled() else None
    (buf_ids, _, _), hops, checks = _traverse(
        (buf_ids, buf_d, buf_vis),
        lambda state, hops: _fused_hop_chunk(index, qp, state, width, hops,
                                             started),
        max_iter, min_iter)
    if started is not None:
        obs.add("cagra.search.hops", hops)
        obs.add("cagra.search.frontier_checks", checks)
        if started:
            _count_k6(started, width)
    with obs.record_span("cagra::finish"):
        out_d, out_ids = _fused_finish(index, qs, buf_ids, k, rt, filter)
    return out_d, out_ids, hops


def _resolve_traversal(params: CagraSearchParams, has_payload: bool, k: int,
                       itopk: int, *, size: int, width: int, degree: int,
                       proj_dim: int, on_cuda: bool, allow_fused: bool = True):
    """The traversal mode and exact re-rank depth → ``(mode, refine_topk)``
    (refine_topk 0 for the exact loop). "auto" takes "fused" when the
    payload is present and the index lives on a card, "compressed" with the
    payload elsewhere, "exact" without it. On a card "fused" is K6, and a
    hop shape K6 cannot take (:func:`hop_shape_error`) raises. Off the card
    an explicit "fused" runs K6's twin where the JAX package runs its fused
    hop (width·degree within :data:`_CAGRA_DEDUP_LIMIT`, where the unfused
    merge dedups exactly too, and a shape K6 takes), and elsewhere the
    compressed loop, which it is bit-identical to. ``allow_fused=False``
    (the shard bodies of :mod:`raft_tpu_torch.distributed.cagra`, as in the
    JAX package) resolves "auto" and "fused" to the compressed loop, on a
    card too: K6 is a single-index kernel there."""
    mode = params.traversal
    if mode == "fused" and has_payload and not allow_fused:
        mode = "compressed"
    if mode == "auto":
        if has_payload:
            mode = "fused" if on_cuda and allow_fused else "compressed"
        else:
            mode = "exact"
    elif mode in ("compressed", "fused") and not has_payload:
        raise ValueError(
            f"traversal={mode!r} needs the compression payload "
            "(build with CagraParams.compress)")
    if mode == "fused":
        why = hop_shape_error(size, itopk, width, degree, proj_dim)
        if on_cuda and why:
            raise ValueError(f"traversal='fused' on a card runs K6, which "
                             f"cannot take this search: {why}; use "
                             f"traversal='compressed'")
        if not on_cuda and (why or width * degree > _CAGRA_DEDUP_LIMIT):
            mode = "compressed"
    rt = 0
    if mode in ("compressed", "fused"):
        rt = int(params.refine_topk) or itopk
        if not k <= rt <= itopk:
            raise ValueError(
                f"refine_topk={rt} must be in [k={k}, itopk={itopk}]")
    return mode, rt


@traced("cagra::search")
def search(index: CagraIndex, queries, k: int,
           params: CagraSearchParams = CagraSearchParams(), filter=None,
           res: Optional[Resources] = None,
           device: Optional[DeviceLike] = None,
           stats: Optional[Dict[str, Any]] = None):
    """Best-first graph search → (distances (q, k) fp32, ids (q, k) int32).
    The buffer holds ``itopk_size`` candidates per query; k must not exceed
    it. Queries are traversed in tiles sized from the workspace. ``stats``,
    when given, receives the resolved ``mode``, ``refine_topk``,
    ``q_tile``, ``tiles`` and the ``hops`` run in each tile, and for the
    fused traversal the hop's ``occupancy``. ``filter``: a
    :class:`~raft_tpu_torch.core.bitset.Bitset` of ``index.size`` bits;
    filtered-out nodes route but never come back."""
    res = resources_for(device, res)
    dev = res.device
    if index.device != dev:
        raise ValueError(f"index lives on {index.device}, search runs on "
                         f"{dev}; move it with index.to(device)")
    queries = torch.as_tensor(queries).to(device=dev, dtype=torch.float32)
    if queries.ndim != 2 or queries.shape[1] != index.dim:
        raise ValueError(f"queries must be (q, {index.dim})")
    itopk = int(min(params.itopk_size, index.size))
    if not 0 < k <= itopk:
        raise ValueError(f"k={k} must be in (0, itopk_size={itopk}]")
    if filter is not None and filter.n_bits != index.size:
        raise ValueError(f"filter covers {filter.n_bits} bits but index has "
                         f"{index.size} rows")
    width = int(params.search_width)
    max_iter = int(params.max_iterations) or max(16, itopk // width)
    min_iter = int(min(params.min_iterations, max_iter))
    b = width * index.graph_degree
    p = index.proj.shape[1] if index.proj is not None else index.dim
    mode, rt = _resolve_traversal(params, index.nbr_codes is not None, int(k),
                                  itopk, size=index.size, width=width,
                                  degree=index.graph_degree, proj_dim=p,
                                  on_cuda=dev.type == "cuda")

    # live bytes per query: the fused hop keeps its state in the kernel, so
    # only the exit re-rank gather and the buffer rows count
    if mode == "fused":
        per_q = 6 * rt * index.dim + 24 * itopk + 4 * p + 8 * width
    elif mode == "compressed":
        per_q = b * b + 4 * b * p + 8 * (itopk + b) + 4 * itopk * index.dim
    else:
        per_q = b * b + 6 * b * index.dim + 8 * (itopk + b)
    nq = queries.shape[0]
    if nq == 0:
        return (torch.zeros((0, k), device=dev),
                torch.zeros((0, k), dtype=torch.int32, device=dev))
    q_tile = int(max(256, min(nq, res.workspace_bytes // max(per_q, 1))))
    n_tiles = -(-nq // q_tile)
    q_tile = -(-nq // n_tiles)

    if obs.enabled():
        obs.add("cagra.search.queries", nq)
        obs.add("cagra.search.tiles", n_tiles)
        obs.add("cagra.search.iterations", nq * max_iter)
        obs.add(f"cagra.search.traversal.{mode}", 1)
        if mode == "fused":
            # K6's static FLOP/byte model and the query-block occupancy;
            # one ``cagra::hop`` span covers one K6 launch, so one hop
            obs_roofline.note_dispatch(
                "cagra.fused_hop",
                {"q": q_tile, "width": width,
                 "degree": index.graph_degree, "proj_dim": p,
                 "itopk": itopk, "hops": 1},
                occupancy=occupancy_stats(
                    min(nq, q_tile), _CAGRA_QBLOCK, width,
                    index.graph_degree, p, itopk))
    faultpoint("cagra.search")
    (gen,) = kmeans_balanced.seeded_generators(params.seed, 1, dev)
    n_rand = int(max(1, params.num_random_samplings))
    outs, hops = [], []
    for s in range(0, nq, q_tile):
        check_interrupt()
        qs = queries[s:s + q_tile]
        if qs.shape[0] < q_tile:
            qs = torch.nn.functional.pad(qs, (0, 0, 0, q_tile - qs.shape[0]))
        if mode == "fused":
            od, oi, h = _run_fused_tile(index, qs, gen, int(k), itopk, width,
                                        max_iter, min_iter, n_rand, rt,
                                        filter)
        elif mode == "compressed":
            od, oi, h = _search_impl_compressed(index, qs, gen, int(k), itopk,
                                                width, max_iter, min_iter,
                                                n_rand, rt, filter)
        else:
            od, oi, h = _search_impl(index.dataset, index.graph, qs, gen,
                                     int(k), itopk, width, max_iter, min_iter,
                                     n_rand, filter)
        outs.append((od, oi))
        hops.append(h)
    if stats is not None:
        stats.update(mode=mode, refine_topk=rt, q_tile=q_tile,
                     tiles=len(outs), hops=hops)
        if mode == "fused":
            stats["occupancy"] = occupancy_stats(
                q_tile, _CAGRA_QBLOCK, width, index.graph_degree, p, itopk)
    return (torch.cat([o[0] for o in outs], dim=0)[:nq],
            torch.cat([o[1] for o in outs], dim=0)[:nq])
