"""Nearest-neighbour indexes (counterpart of ``raft_tpu/neighbors``): brute
force, IVF-Flat, IVF-PQ, IVF-BQ, CAGRA, NN-descent, hybrid, ball cover,
epsilon neighbourhoods and exact refine. Names load on first access."""

from raft_tpu_torch._lazy import attach

_MODULES = ("ball_cover", "brute_force", "cagra", "epsilon_neighborhood",
            "hybrid", "ivf_bq", "ivf_flat", "ivf_pq", "nn_descent", "refine")

__getattr__, __dir__ = attach(__name__, {
    **{n: (n, None) for n in _MODULES},
    "eps_neighbors": ("epsilon_neighborhood", "eps_neighbors"),
})

__all__ = ["ball_cover", "brute_force", "cagra", "epsilon_neighborhood",
           "eps_neighbors", "hybrid", "ivf_bq", "ivf_flat", "ivf_pq",
           "nn_descent", "refine"]
