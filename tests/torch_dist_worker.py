"""The worker of the port's ``process_group`` test: one rank of a gloo
process group on the CPU. It imports neither JAX nor the JAX package, so
a spawned process starts quickly."""

import numpy as np


def gloo_rank(rank: int, world: int, addr: str, queue) -> None:
    """Join the group, run the comms self-test and a small distributed
    brute-force search, and put ``(rank, self_test, vals, ids)`` (or
    ``(rank, "error", text)``) on ``queue``."""
    import traceback

    import torch

    try:
        torch.set_num_threads(1)
        from raft_tpu_torch.comms import (Comms, comms_self_test,
                                          init_distributed,
                                          process_group_mesh,
                                          shutdown_distributed)
        from raft_tpu_torch.core.resources import Resources, use_resources
        from raft_tpu_torch.distributed import brute_force as dbf

        with use_resources(Resources(device="cpu")):
            assert init_distributed(addr, world, rank, timeout_s=60.0)
            assert init_distributed()          # idempotent
            mesh = process_group_mesh()
            checks = comms_self_test(mesh)
            x, q = dataset()
            idx = dbf.build(x, comms=Comms(mesh), device="cpu")
            vals, ids = dbf.search(idx, q, 5, device="cpu")
            shutdown_distributed()
        queue.put((rank, checks, vals.numpy(), ids.numpy()))
    except Exception:  # reported to the parent, which fails the test
        queue.put((rank, "error", traceback.format_exc()))


def dataset():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((301, 8)).astype(np.float32)
    return x, x[:12] + 0.01
