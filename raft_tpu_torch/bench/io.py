"""Real ANN dataset ingestion + ground-truth generation (counterpart of
``raft_tpu/bench/io.py``).

Reference surface: the raft-ann-bench dataset tooling (``get_dataset``
converts ann-benchmarks HDF5 to fvecs/bin formats; ``generate_groundtruth``
computes the exact kNN over the base set). There is no downloader; the
readers cover every on-disk format those tools produce, and
``generate_groundtruth`` computes exact truth with the port's brute force
(batched, any metric; on ``cuda`` unless ``device="cpu"``).

Formats:
  * ``.fvecs`` / ``.ivecs`` / ``.bvecs`` — TEXMEX (sift/gist): each vector
    is an int32 dim header followed by dim payload items (f32/i32/u8).
  * ``.fbin`` / ``.u8bin`` / ``.i8bin`` / ``.ibin`` — big-ann-benchmarks:
    one (n, dim) int32 header, then n·dim payload items.
  * ``.hdf5`` — ann-benchmarks bundles: ``train`` / ``test`` /
    ``neighbors`` / ``distances`` datasets (``h5py`` is imported only when
    such a file is read).

The readers and writers are numpy only, so a file written by either
package is byte-identical to the other's. ``load_real_dataset`` resolves a
directory laid out like the TEXMEX archives (``sift_base.fvecs`` +
``sift_query.fvecs`` + ``sift_groundtruth.ivecs``), a big-ann layout, or a
single HDF5 bundle.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

_VEC_PAYLOAD = {
    ".fvecs": (np.float32, 4),
    ".ivecs": (np.int32, 4),
    ".bvecs": (np.uint8, 1),
}

_BIN_PAYLOAD = {
    ".fbin": np.float32,
    ".u8bin": np.uint8,
    ".i8bin": np.int8,
    ".ibin": np.int32,
}


def read_vecs(path, count: Optional[int] = None) -> np.ndarray:
    """Read a TEXMEX .fvecs/.ivecs/.bvecs file → (n, dim) array."""
    ext = os.path.splitext(str(path))[1]
    if ext not in _VEC_PAYLOAD:
        raise ValueError(f"not a TEXMEX vecs file: {path}")
    dtype, itemsize = _VEC_PAYLOAD[ext]
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size < 4:
        raise ValueError(f"truncated vecs file: {path}")
    dim = int(np.frombuffer(raw[:4].tobytes(), np.int32)[0])
    if dim <= 0:
        raise ValueError(f"bad vecs dim {dim} in {path}")
    row_bytes = 4 + dim * itemsize
    n = raw.size // row_bytes
    if raw.size % row_bytes:
        raise ValueError(
            f"vecs file size {raw.size} not a multiple of row size "
            f"{row_bytes} (dim {dim}): {path}")
    if count is not None:
        n = min(n, int(count))
        raw = raw[: n * row_bytes]
    rows = raw.reshape(n, row_bytes)
    dims = rows[:, :4].copy().view(np.int32).reshape(-1)
    if not np.all(dims == dim):
        raise ValueError(f"inconsistent row dims in {path}")
    return rows[:, 4:].copy().view(dtype).reshape(n, dim)


def write_vecs(path, arr: np.ndarray) -> None:
    """Write (n, dim) → TEXMEX format (dtype chosen by extension).
    Atomic (core/fsio): a killed writer leaves no truncated dataset that a
    later bench run would trip over as a cryptic size-mismatch."""
    from raft_tpu_torch.core.fsio import atomic_write

    ext = os.path.splitext(str(path))[1]
    dtype, _ = _VEC_PAYLOAD[ext]
    arr = np.ascontiguousarray(arr, dtype)
    n, dim = arr.shape
    hdr = np.full((n, 1), dim, np.int32)
    out = np.concatenate([hdr.view(np.uint8).reshape(n, 4),
                          arr.view(np.uint8).reshape(n, -1)], axis=1)
    with atomic_write(path) as f:
        out.tofile(f)


def read_bin(path, count: Optional[int] = None) -> np.ndarray:
    """Read a big-ann .fbin/.u8bin/.i8bin/.ibin file → (n, dim) array."""
    ext = os.path.splitext(str(path))[1]
    if ext not in _BIN_PAYLOAD:
        raise ValueError(f"not a big-ann bin file: {path}")
    dtype = _BIN_PAYLOAD[ext]
    with open(path, "rb") as f:
        n, dim = np.fromfile(f, np.int32, 2)
        n = int(n) if count is None else min(int(n), int(count))
        data = np.fromfile(f, dtype, n * int(dim))
    if data.size != n * int(dim):
        raise ValueError(f"truncated bin file: {path}")
    return data.reshape(n, int(dim))


def write_bin(path, arr: np.ndarray) -> None:
    """Atomic big-ann bin writer (same contract as :func:`write_vecs`)."""
    from raft_tpu_torch.core.fsio import atomic_write

    ext = os.path.splitext(str(path))[1]
    arr = np.ascontiguousarray(arr, _BIN_PAYLOAD[ext])
    with atomic_write(path) as f:
        np.array(arr.shape, np.int32).tofile(f)
        arr.tofile(f)


def read_hdf5(path) -> Dict[str, np.ndarray]:
    """Read an ann-benchmarks HDF5 bundle → dict with ``train``/``test``
    and, when present, ``neighbors``/``distances``."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        for key in ("train", "test", "neighbors", "distances"):
            if key in f:
                out[key] = np.asarray(f[key])
    if "train" not in out or "test" not in out:
        raise ValueError(f"hdf5 bundle missing train/test datasets: {path}")
    return out


def read_any(path, count: Optional[int] = None) -> np.ndarray:
    """Dispatch on extension: TEXMEX vecs, big-ann bin, or .npy."""
    ext = os.path.splitext(str(path))[1]
    if ext in _VEC_PAYLOAD:
        return read_vecs(path, count)
    if ext in _BIN_PAYLOAD:
        return read_bin(path, count)
    if ext == ".npy":
        arr = np.load(path, mmap_mode="r")
        return np.asarray(arr[:count] if count else arr)
    raise ValueError(f"unknown dataset file format: {path}")


def generate_groundtruth(dataset, queries, k: int = 100,
                         metric: str = "sqeuclidean",
                         batch: int = 10_000, res=None,
                         device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Exact kNN ground truth (ids, distances) as host arrays via the
    port's brute force — the generate_groundtruth tool analog. Batched
    over queries so the (q, n) distance block stays bounded. Runs on
    ``cuda`` unless ``device``/``res`` say otherwise."""
    import torch

    from raft_tpu_torch.neighbors import brute_force

    index = brute_force.build(
        torch.as_tensor(np.asarray(dataset, np.float32)), metric=metric,
        res=res, device=device)
    ids_out, d_out = [], []
    queries = np.asarray(queries, np.float32)
    for s in range(0, queries.shape[0], batch):
        v, i = brute_force.search(index, torch.from_numpy(
            queries[s:s + batch]), k, select_algo="exact", res=res,
            device=device)
        ids_out.append(i.cpu().numpy())
        d_out.append(v.cpu().numpy())
    return np.concatenate(ids_out), np.concatenate(d_out)


def load_real_dataset(root, name: str = "sift",
                      max_rows: Optional[int] = None):
    """Resolve a real dataset directory → (base, queries, gt_ids | None).

    Accepts either a TEXMEX layout (``{name}_base.fvecs`` etc. under
    ``root/name`` or ``root``), a big-ann layout (``base.*bin`` +
    ``query.*bin`` + ``groundtruth.ibin``), or ``{name}.hdf5``. Returns
    None when nothing is found — callers fall back to synthetic data.
    """
    root = str(root)
    for d in (os.path.join(root, name), root):
        if not os.path.isdir(d):
            continue
        # TEXMEX layout
        for base_ext in (".fvecs", ".bvecs"):
            base_p = os.path.join(d, f"{name}_base{base_ext}")
            if os.path.exists(base_p):
                qp = next((p for p in (
                    os.path.join(d, f"{name}_query.fvecs"),
                    os.path.join(d, f"{name}_query.bvecs"))
                    if os.path.exists(p)), None)
                if qp is None:
                    continue
                base = read_vecs(base_p, max_rows)
                gt_p = os.path.join(d, f"{name}_groundtruth.ivecs")
                # shipped ground truth is over the FULL base: invalid once
                # max_rows truncates (ids could point past the rows
                # returned) — callers regenerate via generate_groundtruth
                gt = (read_vecs(gt_p)
                      if os.path.exists(gt_p) and max_rows is None else None)
                return (base, read_vecs(qp), gt)
        # big-ann layout
        for base_ext in _BIN_PAYLOAD:
            base_p = os.path.join(d, f"base{base_ext}")
            if os.path.exists(base_p):
                qp = next((os.path.join(d, f"query{e}")
                           for e in _BIN_PAYLOAD
                           if os.path.exists(os.path.join(d, f"query{e}"))),
                          None)
                if qp is None:
                    continue
                gt_p = os.path.join(d, "groundtruth.ibin")
                gt = (read_bin(gt_p)
                      if os.path.exists(gt_p) and max_rows is None else None)
                return (read_bin(base_p, max_rows), read_bin(qp), gt)
    # single-file HDF5 bundle
    for p in (os.path.join(root, f"{name}.hdf5"),
              os.path.join(root, name, f"{name}.hdf5")):
        if os.path.exists(p):
            z = read_hdf5(p)
            base = z["train"][:max_rows] if max_rows else z["train"]
            gt = None if max_rows else z.get("neighbors")
            return base, z["test"], gt
    return None
