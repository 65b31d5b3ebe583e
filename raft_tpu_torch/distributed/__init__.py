"""Multi-shard algorithms over the comms layer (counterpart of
``raft_tpu/distributed/``): each shard holds a row partition, the
algorithms combine per-shard work with the collectives of
:mod:`raft_tpu_torch.comms` — sharded exact kNN, data-sharded k-means,
the sharded IVF-Flat / IVF-PQ / IVF-BQ indexes (one global quantizer, one
index a shard), sharded CAGRA, and snapshots with single-shard restore.
"""

from raft_tpu_torch.distributed import (brute_force, cagra, ivf_bq, ivf_flat,
                                        ivf_pq, kmeans, snapshot)
from raft_tpu_torch.distributed._sharding import (SearchResult, ShardReport,
                                                  probe_shards)

__all__ = ["SearchResult", "ShardReport", "brute_force", "cagra", "ivf_bq",
           "ivf_flat", "ivf_pq", "kmeans", "probe_shards", "snapshot"]
