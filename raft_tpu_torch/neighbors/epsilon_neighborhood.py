"""Dense epsilon-neighbourhood (counterpart of
``raft_tpu/neighbors/epsilon_neighborhood.py``): boolean adjacency and
per-row degree of the pairs within an L2 radius, from one pairwise
squared-distance pass."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.resources import DeviceLike, Resources, resources_for
from raft_tpu_torch.ops import distance as dist_mod


def eps_neighbors(x, y, eps: float, res: Optional[Resources] = None,
                  device: Optional[DeviceLike] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(adjacency (m, n) bool, degree (m,) int32) of pairs with
    ‖x_i − y_j‖² ≤ eps² (eps is the L2 radius, squared in fp32)."""
    res = resources_for(device, res)
    if eps <= 0:
        raise ValueError(f"eps must be positive, got {eps}")
    d2 = dist_mod.pairwise_distance(x, y, "sqeuclidean", res=res)
    adj = d2 <= torch.tensor(eps, dtype=torch.float32) ** 2
    return adj, adj.sum(dim=1, dtype=torch.int32)
