"""Clustering (counterpart of ``raft_tpu/cluster``): Lloyd k-means,
balanced k-means (the IVF coarse quantizer) and single linkage. Names load
on first access."""

from raft_tpu_torch._lazy import attach

__getattr__, __dir__ = attach(__name__, {
    "kmeans": ("kmeans", None),
    "kmeans_balanced": ("kmeans_balanced", None),
    "single_linkage": ("single_linkage", None),
    "single_linkage_fn": ("single_linkage", "single_linkage"),
    "KMeansParams": ("kmeans", "KMeansParams"),
    "LinkageResult": ("single_linkage", "LinkageResult"),
})

__all__ = ["kmeans", "kmeans_balanced", "single_linkage", "single_linkage_fn",
           "KMeansParams", "LinkageResult"]
