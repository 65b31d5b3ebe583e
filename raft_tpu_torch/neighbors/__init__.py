"""Nearest-neighbour indexes: brute force (ground truth), IVF-PQ, exact refine."""
