"""Sparse solvers: Borůvka MST and a Lanczos eigensolver (counterpart of
``raft_tpu/sparse/solver.py``).

MST. Each Borůvka round picks every component's minimum outgoing edge by
cascaded segment minima (``scatter_reduce(..., "amin")``) under the
direction-symmetric key ``(weight, min colour, max colour, entry index)``,
the JAX package's: both directions of an undirected edge share the key, so
the only cycles of the choice graph are mutual pairs, and the smaller
colour of a pair becomes the root. The parent array is then pointer-jumped
⌈log2 n⌉ + 1 times (enough for any forest of n vertices) and every vertex
recoloured. The rounds run in a Python loop with one host read each (any
edge kept?). Every step is a min, a compare or a gather, so the edge set
equals the JAX package's bit for bit.

Lanczos. Each eigenpair is one run of the deflated operator P·A·P
(P = I − U·Uᵀ over the pairs found so far) with full
re-orthogonalization, as in the JAX package. Its start vectors come from a
``torch.Generator`` seeded from ``seed``: torch cannot draw
``jax.random``'s streams, so the two packages agree on eigenvalues and on
the eigenvectors' directions, not on the vectors' signs.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch

from raft_tpu_torch.core.resources import DeviceLike, resolve_device
from raft_tpu_torch.sparse.linalg import spmv
from raft_tpu_torch.sparse.types import COO, CSR

_INT32_MAX = torch.iinfo(torch.int32).max


class MstResult(NamedTuple):
    """MST / forest edges."""

    src: torch.Tensor      # (n-1,) int32, -1 beyond n_edges
    dst: torch.Tensor      # (n-1,) int32
    weight: torch.Tensor   # (n-1,) float32, 0 beyond n_edges
    n_edges: torch.Tensor  # 0-d int32
    color: torch.Tensor    # (n,) int32 final component label per vertex


def _segment_min(values: torch.Tensor, key: torch.Tensor, n: int,
                 empty) -> torch.Tensor:
    """Per-segment minimum over segments [0, n] (segment n collects the
    dead entries) → the first n; an empty segment holds ``empty``."""
    out = torch.full((n + 1,), empty, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce(0, key, values, "amin", include_self=False)[:n]


def _mst_impl(rows, cols, vals, valid, n: int):
    E = rows.shape[0]
    dev = rows.device
    L = max(n - 1, 1)
    out_src = torch.full((L,), -1, dtype=torch.int32, device=dev)
    out_dst = torch.full((L,), -1, dtype=torch.int32, device=dev)
    out_w = torch.zeros(L, dtype=torch.float32, device=dev)
    color = torch.arange(n, dtype=torch.int32, device=dev)
    c_ids = color.clone()
    eids = torch.arange(E, dtype=torch.int32, device=dev)
    r = torch.clamp(rows, 0, n - 1).long()
    c = torch.clamp(cols, 0, n - 1).long()
    jumps = max(1, math.ceil(math.log2(max(n, 2)))) + 1
    count = 0
    while True:
        cu = color[r]
        cv = color[c]
        live = valid & (cu != cv)
        key = torch.where(live, cu, n).long()
        cmin = torch.minimum(cu, cv)
        cmax = torch.maximum(cu, cv)
        cul = cu.long()
        minw = _segment_min(torch.where(live, vals, float("inf")), key, n,
                            float("inf"))
        sel = live & (vals == minw[cul])
        mcmin = _segment_min(torch.where(sel, cmin, n), key, n, _INT32_MAX)
        sel &= cmin == mcmin[cul]
        mcmax = _segment_min(torch.where(sel, cmax, n), key, n, _INT32_MAX)
        sel &= cmax == mcmax[cul]
        eidx = _segment_min(torch.where(sel, eids, E), key, n, _INT32_MAX)
        has_edge = eidx < E
        e = torch.clamp(eidx, 0, E - 1).long()
        t = torch.where(has_edge, cv[e], c_ids)
        # break mutual pairs (the only possible cycles): the smaller colour
        # roots
        mutual = t[t.long()] == c_ids
        is_root = ~has_edge | (mutual & (c_ids < t))
        p = torch.where(is_root, c_ids, t)
        for _ in range(jumps):
            p = p[p.long()]
        keep = has_edge & ~is_root
        # append the kept edges at [count, count + n_kept): select them
        # before the scatter, nothing is written out of range
        kept = keep.nonzero().squeeze(1)
        n_kept = int(kept.numel())
        if n_kept:
            pos = torch.clamp(count + torch.arange(n_kept, device=dev),
                              0, L - 1)
            ek = e[kept]
            out_src[pos] = rows[ek]
            out_dst[pos] = cols[ek]
            out_w[pos] = vals[ek].to(torch.float32)
        color = p[color.long()]
        count += n_kept
        if n_kept == 0:
            break
    return out_src, out_dst, out_w, count, color


def mst(graph: COO) -> MstResult:
    """Minimum spanning tree / forest of a symmetric weighted COO graph;
    ``graph`` must hold both directions of every undirected edge (as
    :func:`raft_tpu_torch.sparse.neighbors.knn_graph` and
    :func:`raft_tpu_torch.sparse.linalg.symmetrize` make)."""
    n, m = graph.shape
    if n != m:
        raise ValueError(f"graph must be square, got {graph.shape}")
    if n < 2:
        raise ValueError("graph needs at least 2 vertices")
    src, dst, w, cnt, color = _mst_impl(graph.rows, graph.cols, graph.vals,
                                        graph.valid, n)
    return MstResult(src, dst, w,
                     torch.tensor(cnt, dtype=torch.int32, device=src.device),
                     color)


def connected_components(graph: COO) -> torch.Tensor:
    """Per-vertex component labels, by the same contraction."""
    return mst(graph).color


# ---------------------------------------------------------------------------
# Lanczos
# ---------------------------------------------------------------------------

def _lanczos_run(matvec: Callable, n: int, m: int, v0: torch.Tensor,
                 U: torch.Tensor):
    """One Lanczos run of P·A·P, P = I − U·Uᵀ (zero columns of U are
    no-ops) → (V (m, n), alphas (m,), betas (m,))."""
    v0 = v0 / torch.linalg.vector_norm(v0)
    V = torch.zeros((m, n), dtype=torch.float32, device=v0.device)
    V[0] = v0
    alphas = torch.zeros(m, dtype=torch.float32, device=v0.device)
    betas = torch.zeros(m, dtype=torch.float32, device=v0.device)
    beta_prev = torch.zeros((), dtype=torch.float32, device=v0.device)
    for i in range(m):
        v = V[i]
        w = matvec(v - U @ (U.T @ v))
        w = w - U @ (U.T @ w)
        alpha = torch.dot(w, v)
        w = w - alpha * v
        if i > 0:
            w = w - beta_prev * V[i - 1]
        # full re-orthogonalization against every earlier vector (rows past
        # i are zero), then the deflation scrub last
        w = w - V.T @ (V @ w)
        w = w - U @ (U.T @ w)
        beta = torch.linalg.vector_norm(w)
        v_next = torch.where(beta > 1e-10, w / torch.clamp(beta, min=1e-30),
                             torch.zeros_like(w))
        if i + 1 < m:
            V[i + 1] = v_next
        alphas[i] = alpha
        betas[i] = beta
        beta_prev = beta
    return V, alphas, betas


def lanczos_smallest(a: Union[CSR, Callable], n_components: int,
                     n: Optional[int] = None, max_iters: int = 0,
                     seed: int = 0, device: Optional[DeviceLike] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest eigenpairs of a symmetric operator → (eigenvalues (k,),
    eigenvectors (n, k)). ``a``: a CSR matrix (the run lives on its
    device) or a matvec callable (then ``n`` is required, and the run lives
    on ``device``, ``cuda`` unless the caller asks for the CPU)."""
    if isinstance(a, CSR):
        if a.shape[0] != a.shape[1]:
            raise ValueError("operator must be square")
        n = a.shape[0]
        csr = a
        dev = csr.device

        def matvec(v):
            return spmv(csr, v)
    else:
        if n is None:
            raise ValueError("n is required when `a` is a callable")
        matvec = a
        dev = resolve_device(device)
    k = int(n_components)
    if not 0 < k <= n:
        raise ValueError(f"need 0 < n_components <= {n}")
    m = int(max_iters) if max_iters else min(n, max(4 * k, 32))
    m = min(m, n)

    # sequential deflation: one Krylov space holds at most one eigenvector
    # of a degenerate eigenvalue, so each pair gets its own run
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    found_vals, found_vecs = [], []
    for _ in range(k):
        U = torch.zeros((n, k), dtype=torch.float32, device=dev)
        for jj, u in enumerate(found_vecs):
            U[:, jj] = u
        v0 = torch.randn(n, generator=gen, dtype=torch.float32, device=dev)
        v0 = v0 - U @ (U.T @ v0)
        V, alphas, betas = _lanczos_run(matvec, n, m, v0, U)
        # after a happy breakdown (beta ~ 0) the later (alpha, beta) are
        # garbage zeros: rank them last
        good = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          torch.cumprod((betas[:-1] > 1e-8).to(torch.int32),
                                        0).to(torch.bool)])
        alphas = torch.where(good, alphas, 1e30)
        offd = torch.where(good[1:], betas[:-1], 0.0)
        T = torch.diag(alphas) + torch.diag(offd, 1) + torch.diag(offd, -1)
        evals, S = torch.linalg.eigh(T)
        vec = V.T @ S[:, 0]
        vec = vec / torch.clamp(torch.linalg.vector_norm(vec), min=1e-30)
        found_vals.append(evals[0])
        found_vecs.append(vec)
    vals = torch.stack(found_vals)
    order = torch.argsort(vals, stable=True)
    return vals[order], torch.stack(found_vecs, dim=1)[:, order]
