"""Random rotations for the IVF-PQ quantizer front end (counterpart of the
rotation part of ``raft_tpu/ops/linalg.py``). Only the dense kind is ported;
the SRHT kind arrives with IVF-BQ."""

from __future__ import annotations

import torch


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


def rotate_rows(x: torch.Tensor, rotation: torch.Tensor,
                kind: str = "dense") -> torch.Tensor:
    """Rows of ``x`` (zero-padded to the rotation width) through the
    rotation. Only ``kind="dense"`` exists in this slice."""
    if kind != "dense":
        raise NotImplementedError(
            f"rotation kind {kind!r} arrives with the IVF-BQ slice")
    return pad_rot(x, rotation.shape[0]) @ rotation.T
