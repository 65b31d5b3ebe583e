"""Random rotations for the IVF quantizer front ends (counterpart of the
rotation part of ``raft_tpu/ops/linalg.py``).

Two representations (``ROTATION_KINDS``):

* ``"dense"`` — an explicit orthogonal (rot_dim, rot_dim) matrix
  (:func:`make_rotation_matrix`), applied as one gemm;
* ``"hadamard"`` — the SRHT rotation ``R = H·D/√d`` stored as only its
  (rot_dim,) ±1 sign diagonal ``D`` (:func:`make_srht_signs`), applied in
  O(d·log d) by the fast Walsh–Hadamard butterfly (:func:`srht_rotate`).

Both are exactly orthogonal, so ``‖R·x‖ = ‖x‖`` either way. The
decompositions CAGRA's PCA projection needs (``sign_flip``, ``eig_dc``)
close the module.
"""

from __future__ import annotations

import math

import torch

ROTATION_KINDS = ("dense", "hadamard")


def pad_rot(x: torch.Tensor, rot_dim: int) -> torch.Tensor:
    """Zero-pad the trailing dim of ``x`` up to ``rot_dim``."""
    pad = rot_dim - x.shape[-1]
    if pad == 0:
        return x
    return torch.nn.functional.pad(x, (0, pad))


def make_rotation_matrix(generator: torch.Generator, rot_dim: int,
                         device: torch.device) -> torch.Tensor:
    """Random orthogonal (rot_dim, rot_dim) via QR of a Gaussian drawn from
    ``generator`` on its own device (factorized in fp64, returned as fp32
    on ``device``); column signs follow ``diag(r)`` as in the JAX
    package."""
    g = torch.randn((rot_dim, rot_dim), generator=generator,
                    device=generator.device, dtype=torch.float64)
    q, r = torch.linalg.qr(g)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q.to(torch.float32).to(device)


def hadamard_rot_dim(dim: int) -> int:
    """Rotation width of the SRHT kind: the next power of two ≥ dim, at
    least 8 (whole code bytes)."""
    return max(8, 1 << max(0, math.ceil(math.log2(max(int(dim), 1)))))


def make_srht_signs(generator: torch.Generator, rot_dim: int,
                    device: torch.device) -> torch.Tensor:
    """The SRHT sign diagonal: (rot_dim,) fp32 in {−1, +1}, fair coin flips
    from ``generator``. ``rot_dim`` must be a power of two."""
    if rot_dim & (rot_dim - 1) or rot_dim < 2:
        raise ValueError(f"SRHT needs a power-of-two rot_dim, got {rot_dim}")
    u = torch.rand((rot_dim,), generator=generator, device=generator.device)
    return torch.where(u < 0.5, 1.0, -1.0).to(torch.float32).to(device)


def hadamard_transform(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized fast Walsh–Hadamard transform along the last axis
    (``x @ H_d`` for the symmetric ±1 Hadamard matrix) as log2(d) butterfly
    stages, in the JAX package's order of operations. The last axis must be
    a power of two."""
    d = x.shape[-1]
    if d & (d - 1) or d < 1:
        raise ValueError(f"hadamard_transform needs a power-of-two width, got {d}")
    shape = x.shape
    h = 1
    while h < d:
        y = x.reshape(*shape[:-1], d // (2 * h), 2, h)
        a, b = y[..., 0, :], y[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2).reshape(shape)
        h *= 2
    return x


def srht_rotate(x: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` through ``R = H·D/√d``: ``fwht(x·D)/√d``."""
    d = signs.shape[-1]
    inv = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    return hadamard_transform(x * signs) * inv


def rotate_rows(x: torch.Tensor, rotation: torch.Tensor,
                kind: str = "dense") -> torch.Tensor:
    """Rows of ``x`` (zero-padded to the rotation width) through the
    rotation: ``rotation`` is the dense matrix for ``kind="dense"``, the
    (rot_dim,) sign diagonal for ``kind="hadamard"``."""
    if kind == "dense":
        return pad_rot(x, rotation.shape[0]) @ rotation.T
    if kind == "hadamard":
        return srht_rotate(pad_rot(x, rotation.shape[0]), rotation)
    raise ValueError(f"unknown rotation kind {kind!r} (expected one of "
                     f"{ROTATION_KINDS})")



def unrotate_rows(y: torch.Tensor, rotation: torch.Tensor,
                  kind: str = "dense") -> torch.Tensor:
    """Inverse of :func:`rotate_rows`, back onto the (padded) input space:
    ``y @ R`` for the dense matrix, ``D·fwht(y)/√d`` for the SRHT (both
    kinds are exactly orthogonal). Callers slice ``[..., :dim]``."""
    if kind == "dense":
        return y @ rotation
    if kind == "hadamard":
        d = rotation.shape[-1]
        inv = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
        return hadamard_transform(y) * inv * rotation
    raise ValueError(f"unknown rotation kind {kind!r} (expected one of "
                     f"{ROTATION_KINDS})")


def rotation_matrix_of(rotation: torch.Tensor,
                       kind: str = "dense") -> torch.Tensor:
    """The explicit (rot_dim, rot_dim) matrix of either representation."""
    if kind == "dense":
        return rotation
    if kind == "hadamard":
        d = rotation.shape[-1]
        eye = torch.eye(d, dtype=torch.float32, device=rotation.device)
        return srht_rotate(eye, rotation).T
    raise ValueError(f"unknown rotation kind {kind!r} (expected one of "
                     f"{ROTATION_KINDS})")

# -- decompositions ----------------------------------------------------------


def sign_flip(u: torch.Tensor) -> torch.Tensor:
    """Deterministic sign convention: flip each column so its largest-|.|
    element (the first, on ties) is positive."""
    idx = torch.argmax(torch.abs(u), dim=0)
    signs = torch.sign(u[idx, torch.arange(u.shape[1], device=u.device)])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return u * signs[None, :]


def eig_dc(a: torch.Tensor):
    """Symmetric eigendecomposition → (ascending eigenvalues, eigenvectors
    as columns under :func:`sign_flip`)."""
    w, v = torch.linalg.eigh(a)
    return w, sign_flip(v)
