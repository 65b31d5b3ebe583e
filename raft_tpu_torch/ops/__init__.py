"""Dense compute primitives (counterpart of ``raft_tpu/ops``): pairwise
distances, top-k selection, dense linear algebra and matrix ops, Gram
kernels, and the list-scan engines with their hand-written Hopper kernels
(``csrc/``). Names load on first access."""

from raft_tpu_torch._lazy import attach

__getattr__, __dir__ = attach(__name__, {
    "distance": ("distance", None),
    "kernels": ("kernels", None),
    "strip_scan": ("strip_scan", None),
    "linalg": ("linalg", None),
    "matrix": ("matrix", None),
    "select_k": ("select_k", None),
    "pairwise_distance": ("distance", "pairwise_distance"),
    "fused_l2_nn_argmin": ("distance", "fused_l2_nn_argmin"),
    "select_k_fn": ("select_k", "select_k"),
})

__all__ = ["distance", "kernels", "strip_scan", "linalg", "matrix",
           "select_k", "pairwise_distance", "fused_l2_nn_argmin"]
