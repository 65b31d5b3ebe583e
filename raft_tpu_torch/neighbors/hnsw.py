"""CAGRA → hnswlib export (counterpart of ``raft_tpu/neighbors/hnsw.py``).

Not ported yet: the export and its reader arrive with a later slice of the
port, which can reuse the JAX package's writer format as it stands."""

from __future__ import annotations

_LATER = ("arrives with a later slice of the PyTorch port (the CAGRA "
          "remainder: nn_descent, hnsw export, distributed search)")


def save_to_hnswlib(index, path) -> None:
    """Write a CagraIndex as a base-layer-only hnswlib file: a later slice."""
    raise NotImplementedError(f"hnsw export {_LATER}")
