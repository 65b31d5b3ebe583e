"""Benchmark datasets."""
