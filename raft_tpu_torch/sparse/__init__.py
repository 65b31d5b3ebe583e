"""Sparse tier (counterpart of ``raft_tpu/sparse/``): COO/CSR containers,
conversions, structural ops, linalg, distances, neighbours and solvers
(Borůvka MST, Lanczos), all fixed-capacity and padding-based (see
``types.py``)."""

from raft_tpu_torch.sparse import convert, distance, linalg, neighbors, op, solver
from raft_tpu_torch.sparse.convert import coo_sort, coo_to_csr, csr_to_coo
from raft_tpu_torch.sparse.solver import (MstResult, connected_components,
                                          lanczos_smallest, mst)
from raft_tpu_torch.sparse.types import (COO, CSR, coo_from_dense,
                                         coo_from_parts, csr_from_dense)

__all__ = [
    "COO", "CSR", "MstResult",
    "convert", "distance", "linalg", "neighbors", "op", "solver",
    "coo_from_dense", "coo_from_parts", "csr_from_dense",
    "coo_sort", "coo_to_csr", "csr_to_coo",
    "connected_components", "lanczos_smallest", "mst",
]
