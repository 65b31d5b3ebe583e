"""Benchmark datasets (counterpart of ``raft_tpu/bench/datasets.py``).

``sift_like`` is the JAX package's SIFT-shaped synthetic, generated by the
same numpy calls from the same seed, so both packages see the same rows.
The port keeps nothing on disk: the data is made anew on every call
(about half a minute at 1M × 128 on one core). :func:`data_dir` is where
real datasets are looked up (``bench/io.load_real_dataset``)."""

from __future__ import annotations

import os

import numpy as np


def data_dir() -> str:
    """The dataset root: ``RAFT_TPU_DATA_DIR``, default
    ``~/.cache/raft_tpu_data`` — the one default every consumer (the bench
    runner's ``real`` datasets) resolves through, as in the JAX package."""
    return os.environ.get(
        "RAFT_TPU_DATA_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "raft_tpu_data"),
    )


def sift_like(n: int, dim: int = 128, n_queries: int = 10_000, seed: int = 0):
    """(dataset uint8 (n, dim), queries uint8 (n_queries, dim)): a two-level
    Zipf-weighted mixture with anisotropic clusters, mixed through a random
    basis with a decaying spectrum, rectified and clipped to uint8."""
    rng = np.random.default_rng(seed)
    n_coarse = max(64, min(4096, n // 256))
    total = n + n_queries

    w = 1.0 / np.arange(1, n_coarse + 1) ** 0.7
    w /= w.sum()
    assign = rng.choice(n_coarse, total, p=w)

    centers = rng.standard_normal((n_coarse, dim)).astype(np.float32) * 2.0
    spread = (0.5 + rng.random((n_coarse, dim)) * 1.5).astype(np.float32)

    x = centers[assign] + rng.standard_normal((total, dim)).astype(np.float32) \
        * spread[assign]

    basis = np.linalg.qr(rng.standard_normal((dim, dim)))[0].astype(np.float32)
    spectrum = (1.0 / np.sqrt(1.0 + np.arange(dim) / 8.0)).astype(np.float32)
    x = x @ (basis * spectrum[None, :])

    x = np.maximum(x, 0.0)
    scale = 110.0 / max(np.percentile(x, 99.5), 1e-6)
    x = np.clip(x * scale, 0, 255).astype(np.uint8)
    return x[:n], x[n:]
