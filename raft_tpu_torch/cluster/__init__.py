"""Clustering: balanced k-means (the IVF coarse quantizer)."""
