"""Primitives: top-k selection, distances, rotations, and the strip scan."""
