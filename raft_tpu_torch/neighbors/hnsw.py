"""CAGRA → hnswlib export and a host-side reader and search (counterpart
of ``raft_tpu/neighbors/hnsw.py``; reference neighbors/hnsw.hpp, writer
detail/cagra/cagra_serialize.cuh serialize_to_hnswlib).

:func:`save_to_hnswlib` writes the base-layer-only hnswlib
``HierarchicalNSW<float>`` layout the JAX package writes, byte for byte:
``max_level`` is 0 (not the reference's 1), so the file loads in stock
hnswlib. The writer is native C++ (``raft_tpu_torch/native/``, built with
``g++`` into ``raft_tpu_torch/_build/``) with a pure-Python twin that
writes the same bytes where no compiler is found; the function returns
which one wrote the file.

:class:`HnswIndex` is a self-contained reader and greedy base-layer search
in numpy (hnswlib is not a dependency): the round-trip oracle of the
writer. Both are host code; nothing here runs on a card.
"""

from __future__ import annotations

import ctypes
import heapq
import struct
from dataclasses import dataclass

import numpy as np

from raft_tpu_torch.core.fsio import atomic_replace, atomic_write

_HEADER = struct.Struct("<QQQQQQiiQQQdQ")

def _host_arrays(index):
    graph = index.graph
    data = index.dataset
    if hasattr(graph, "cpu"):
        graph, data = graph.cpu().numpy(), data.cpu().numpy()
    graph = np.ascontiguousarray(np.asarray(graph), dtype=np.uint32)
    data = np.ascontiguousarray(np.asarray(data), dtype=np.float32)
    if data.shape[0] != graph.shape[0]:
        raise ValueError(f"graph rows {graph.shape[0]} != dataset rows "
                         f"{data.shape[0]}")
    return graph, data


def write_native(lib, path, graph: np.ndarray, data: np.ndarray,
                 entry: int) -> None:
    """The C++ writer (``lib`` from ``native.get_native_lib()``), atomic."""
    n, degree = graph.shape

    def produce(tmp_path):
        rc = lib.raft_torch_write_hnsw(
            tmp_path.encode(), n, data.shape[1], degree,
            graph.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), entry)
        if rc != 0:
            raise OSError(f"native hnsw writer failed with code {rc} "
                          f"for {path}")

    atomic_replace(str(path), produce)


def write_python(path, graph: np.ndarray, data: np.ndarray,
                 entry: int) -> None:
    """The pure-Python writer: the native writer's bytes, atomic."""
    n, degree = graph.shape
    dim = data.shape[1]
    size_per_el = degree * 4 + 4 + dim * 4 + 8
    with atomic_write(str(path)) as f:
        f.write(_HEADER.pack(0, n, n, size_per_el, size_per_el - 8,
                             degree * 4 + 4, 0, entry, degree // 2, degree,
                             degree // 2, 0.42424242, 500))
        lab = np.empty(1, np.uint64)
        deg = np.full(1, degree, np.int32)
        for i in range(n):
            deg.tofile(f)
            graph[i].tofile(f)
            data[i].tofile(f)
            lab[0] = i
            lab.tofile(f)
        np.zeros(n, np.int32).tofile(f)


def save_to_hnswlib(index, path) -> str:
    """Write a CAGRA index (either package's, or anything with ``graph``
    and ``dataset``) as a base-layer-only hnswlib file (per element:
    links_count u32, the graph row as u32s, the vector as f32s, the label
    u64; then a zero u32 per element for the absent upper levels). The
    entry point is row n/2, as the reference picks it. Returns the writer
    that wrote it: "native" or "python"."""
    from raft_tpu_torch.native import get_native_lib

    graph, data = _host_arrays(index)
    entry = graph.shape[0] // 2
    lib = get_native_lib()
    if lib is not None:
        write_native(lib, path, graph, data, entry)
        return "native"
    write_python(path, graph, data, entry)
    return "python"


@dataclass
class HnswIndex:
    """A parsed base-layer-only hnswlib index."""

    graph: np.ndarray    # (n, degree) uint32
    dataset: np.ndarray  # (n, dim) float32
    labels: np.ndarray   # (n,) uint64
    entrypoint: int

    @classmethod
    def load(cls, path, dim: int) -> "HnswIndex":
        """Parse an hnswlib file of known ``dim`` (hnswlib's loader needs
        the space dim too). The layout has no magic, so the header is
        checked structurally before any parse: a wrong-kind, corrupt or
        truncated file raises ``ValueError`` naming what is wrong."""
        with open(path, "rb") as f:
            head = f.read(_HEADER.size)
            if head[:8] == b"RAFTTPU\x00":
                raise ValueError(
                    f"{path} is a raft_tpu container, not an hnswlib "
                    f"index — load it with the matching Index.load()")
            if len(head) < _HEADER.size:
                raise ValueError(
                    f"not an hnswlib index: {path} holds {len(head)} bytes, "
                    f"shorter than the {_HEADER.size}-byte header")
            (_, max_el, n, size_per_el, label_off, offset_data, _,
             entry, _, _, _, _, _) = _HEADER.unpack(head)
            degree = (offset_data - 4) // 4
            if not (0 < n <= max_el) or degree <= 0 or \
                    offset_data != degree * 4 + 4 or \
                    label_off != size_per_el - 8 or not 0 <= entry < n:
                raise ValueError(
                    f"not a CAGRA-exported hnswlib index: header invariants "
                    f"violated (n={n}, max_el={max_el}, degree={degree}, "
                    f"offset_data={offset_data}, label_off={label_off}, "
                    f"size_per_el={size_per_el}, entry={entry}) in {path}")
            if size_per_el != degree * 4 + 4 + dim * 4 + 8:
                raise ValueError(
                    f"dim {dim} inconsistent with element size {size_per_el}")
            raw = np.fromfile(f, np.uint8, n * size_per_el)
            if raw.size < n * size_per_el:
                raise ValueError(
                    f"truncated hnswlib index: {path} holds {raw.size} of "
                    f"{n * size_per_el} element bytes — partial write")
        el = raw.reshape(n, size_per_el)
        counts = el[:, :4].view(np.int32)[:, 0]
        graph = np.ascontiguousarray(el[:, 4:offset_data]).view(
            np.uint32).reshape(n, degree)
        dat = np.ascontiguousarray(el[:, offset_data:label_off]).view(
            np.float32).reshape(n, dim)
        labels = np.ascontiguousarray(el[:, label_off:]).view(np.uint64)[:, 0]
        if not (counts == degree).all():
            raise ValueError("variable link counts: not a CAGRA-exported index")
        return cls(graph, dat, labels, int(entry))

    def knn(self, queries, k: int, ef: int = 64, n_iters: int | None = None):
        """Greedy best-first base-layer search (hnswlib's
        searchBaseLayerST, in numpy): it stops as hnswlib does, when the
        candidate heap is empty or its best is past the ef-th result;
        ``n_iters`` caps the expansions (None: uncapped). The JAX
        package's search with its sorted lists as heaps: the same (distance,
        row) order, so the same results.
        → (distances (q, k), labels (q, k))."""
        q = np.asarray(queries, np.float32)
        n = self.graph.shape[0]
        ef = max(ef, k)
        if n_iters is None:
            n_iters = n          # a safety bound only
        out_d = np.empty((q.shape[0], k), np.float32)
        out_i = np.empty((q.shape[0], k), np.int64)
        for r in range(q.shape[0]):
            qv = q[r]
            e = self.entrypoint
            visited = {e}
            d_e = float(((self.dataset[e] - qv) ** 2).sum())
            cand = [(d_e, e)]             # min-heap of (d, row)
            best = [(-d_e, -e)]           # max-heap of (d, row), negated
            for _ in range(n_iters):
                if not cand:
                    break
                d0, u = heapq.heappop(cand)
                worst = -best[0][0] if len(best) >= ef else np.inf
                if d0 > worst:
                    break
                nbrs = [int(v) for v in self.graph[u] if v not in visited]
                visited.update(nbrs)
                if nbrs:
                    dv = ((self.dataset[nbrs] - qv) ** 2).sum(axis=1)
                    for dd, v in zip(dv.tolist(), nbrs):
                        if len(best) < ef or dd < -best[0][0]:
                            heapq.heappush(best, (-dd, -v))
                            heapq.heappush(cand, (dd, v))
                            if len(best) > ef:
                                heapq.heappop(best)
            top = sorted((-nd, -nv) for nd, nv in best)[:k]
            while len(top) < k:
                top.append((np.inf, -1))
            out_d[r] = [t[0] for t in top]
            out_i[r] = [int(self.labels[t[1]]) if t[1] >= 0 else -1
                        for t in top]
        return out_d, out_i
