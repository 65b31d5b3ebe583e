"""Sharded CAGRA (counterpart of ``raft_tpu/distributed/cagra.py``).

Not ported yet: the sharded build and search arrive with the distributed
slice of the port (``torch.distributed`` collectives in place of
``shard_map``)."""

from __future__ import annotations

_LATER = "arrives with the distributed slice of the PyTorch port"


def build(*args, **kwargs):
    """Build one CAGRA index per shard: a later slice."""
    raise NotImplementedError(f"distributed cagra build {_LATER}")


def search(*args, **kwargs):
    """Search every shard and merge: a later slice."""
    raise NotImplementedError(f"distributed cagra search {_LATER}")
