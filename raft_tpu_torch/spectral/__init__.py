"""Spectral graph partitioning (counterpart of ``raft_tpu/spectral/``):
Laplacian eigenvectors + k-means, and partition quality analysis."""

from raft_tpu_torch.spectral.partition import analyze_partition, fit_embedding, partition

__all__ = ["analyze_partition", "fit_embedding", "partition"]
