"""Dense linear algebra, reductions and random rotations (counterpart of
``raft_tpu/ops/linalg.py``).

* **gemm and friends** — ``gemm`` / ``dot`` multiply fp32 operands (bf16
  and int8 inputs are widened first: no second rounding before ``alpha``,
  and a float product for int8, which CUDA torch has no general matmul
  for), then cast back to the input dtype as the JAX package does;
* **keyed reductions** — ``reduce_rows_by_key`` / ``reduce_cols_by_key``
  / weighted ``bincount`` are a sort-and-segment sum: keys outside
  ``[0, n_keys)`` are dropped (what ``jax.nn.one_hot``'s all-zero rows do),
  the rest stably sorted, and each segment summed as the difference of
  two float64 prefix sums. No one-hot block and no atomics: the result is
  the same bits on every call;
* **decompositions** — ``qr``, ``svd``, ``rsvd``, ``lstsq`` (the
  minimum-norm solution through the SVD, ``rcond = eps·max(m, n)``, as
  ``jnp.linalg.lstsq``), ``eig_dc`` and ``lanczos``. ``svd`` and ``rsvd``
  flip each row of ``vt`` with the sign ``sign_flip`` gives its column of
  ``u``, so their factors rebuild the input (the JAX package flips ``u``
  alone);
* **rotations** (the IVF quantizer front ends), in two representations
  (``ROTATION_KINDS``): ``"dense"`` — an explicit orthogonal (rot_dim,
  rot_dim) matrix (:func:`make_rotation_matrix`), applied as one gemm;
  ``"hadamard"`` — the SRHT rotation ``R = H·D/√d`` stored as only its
  (rot_dim,) ±1 sign diagonal ``D`` (:func:`make_srht_signs`), applied in
  O(d·log d) by the fast Walsh–Hadamard butterfly (:func:`srht_rotate`).
  Both are exactly orthogonal, so ``‖R·x‖ = ‖x‖`` either way.

Every entry point added for the dense surface takes ``device=None,
res=None`` and moves its operands to :func:`resolve_device`'s answer.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from raft_tpu_torch.core.resources import (DeviceLike, Resources,
                                           resolve_device, to_device)


def _float(x: torch.Tensor) -> torch.Tensor:
    """Integer and bool tensors as float32 (``jnp``'s inexact promotion)."""
    return x if x.is_floating_point() else x.to(torch.float32)


def gemm(a, b, transpose_a: bool = False, transpose_b: bool = False,
         alpha: float = 1.0, beta: float = 0.0, c=None,
         device: Optional[DeviceLike] = None,
         res: Optional[Resources] = None) -> torch.Tensor:
    """``alpha·op(a)·op(b) + beta·c`` with an fp32 product on fp32
    operands, cast back to ``a``'s dtype (saturating for integer dtypes,
    as XLA's conversion does)."""
    dev = resolve_device(device, res)
    a, b = to_device(a, dev), to_device(b, dev)
    opa = a.T if transpose_a else a
    opb = b.T if transpose_b else b
    out = alpha * (opa.to(torch.float32) @ opb.to(torch.float32))
    if c is not None and beta != 0.0:
        out = out + beta * to_device(c, dev)
    if not a.dtype.is_floating_point:
        info = torch.iinfo(a.dtype)
        out = torch.clamp(out, info.min, info.max)
    return out.to(a.dtype)


def dot(x, y, device: Optional[DeviceLike] = None,
        res: Optional[Resources] = None) -> torch.Tensor:
    """``x·y`` (vectors or matrices) as an fp32 product of fp32 operands."""
    dev = resolve_device(device, res)
    return torch.matmul(to_device(x, dev).to(torch.float32),
                        to_device(y, dev).to(torch.float32))


def axpy(alpha, x, y, device: Optional[DeviceLike] = None,
         res: Optional[Resources] = None) -> torch.Tensor:
    """``alpha·x + y``."""
    dev = resolve_device(device, res)
    return alpha * to_device(x, dev) + to_device(y, dev)


# -- norms, normalization, reductions ----------------------------------------

_NORM_FNS = {
    "l1": lambda x, ax: torch.sum(torch.abs(x), dim=ax),
    "l2": lambda x, ax: torch.sqrt(torch.sum(x * x, dim=ax)),
    "sql2": lambda x, ax: torch.sum(x * x, dim=ax),
    "linf": lambda x, ax: torch.amax(torch.abs(x), dim=ax),
}


def norm(x, norm_type: str = "l2", axis: int = 1,
         device: Optional[DeviceLike] = None,
         res: Optional[Resources] = None) -> torch.Tensor:
    """Row (``axis=1``) or column (``axis=0``) norms: ``"l1"``, ``"l2"``,
    ``"sql2"`` (squared L2) or ``"linf"``."""
    if norm_type not in _NORM_FNS:
        raise ValueError(f"unknown norm {norm_type!r}")
    x = _float(to_device(x, resolve_device(device, res)))
    return _NORM_FNS[norm_type](x, axis)


def normalize(x, norm_type: str = "l2", axis: int = 1, eps: float = 1e-30,
              device: Optional[DeviceLike] = None,
              res: Optional[Resources] = None) -> torch.Tensor:
    """``x`` divided by its row (or column) norms, floored at ``eps``."""
    x = _float(to_device(x, resolve_device(device, res)))
    n = torch.clamp(norm(x, norm_type, axis, device=x.device), min=eps)
    return x / (n[:, None] if axis == 1 else n[None, :])


_REDUCE_FNS = {
    "sum": lambda x, ax: torch.sum(x, dim=ax),
    "min": lambda x, ax: torch.amin(x, dim=ax),
    "max": lambda x, ax: torch.amax(x, dim=ax),
    "mean": lambda x, ax: torch.mean(_float(x), dim=ax),
}


def reduce(x, axis: int = 1, op: str = "sum",
           main_op: Optional[Callable] = None,
           device: Optional[DeviceLike] = None,
           res: Optional[Resources] = None) -> torch.Tensor:
    """Row (``axis=1``) or column (``axis=0``) ``op`` ∈ sum, min, max,
    mean; ``main_op`` maps the elements first (a function of tensors)."""
    x = to_device(x, resolve_device(device, res))
    if main_op is not None:
        x = main_op(x)
    return _REDUCE_FNS[op](x, axis)


def _segment_sum(values: torch.Tensor, keys: torch.Tensor,
                 n_keys: int) -> torch.Tensor:
    """Sum of the rows of ``values`` (m, k) per key → (n_keys, k) float64.
    Keys outside ``[0, n_keys)`` are dropped. A stable sort by key, then
    each segment as the difference of two float64 prefix sums: the same
    order of additions on every call, and no fp32 cancellation."""
    keys = keys.reshape(-1).to(torch.int64)
    valid = (keys >= 0) & (keys < n_keys)
    keys, values = keys[valid], values[valid]
    order = torch.argsort(keys, stable=True)
    csum = torch.cumsum(values[order].to(torch.float64), dim=0)
    csum = torch.cat([torch.zeros((1,) + tuple(csum.shape[1:]),
                                  dtype=csum.dtype, device=csum.device), csum])
    counts = torch.bincount(keys, minlength=n_keys)
    ends = torch.cumsum(counts, dim=0)
    return csum[ends] - csum[ends - counts]


def reduce_rows_by_key(x, keys, n_keys: int,
                       device: Optional[DeviceLike] = None,
                       res: Optional[Resources] = None) -> torch.Tensor:
    """Sum the rows of ``x`` (m, k) grouped by ``keys`` (m,) → (n_keys, k)
    in ``x``'s dtype; keys outside ``[0, n_keys)`` count nowhere (the
    k-means centroid update)."""
    dev = resolve_device(device, res)
    x = to_device(x, dev)
    return _segment_sum(x, to_device(keys, dev), int(n_keys)).to(x.dtype)


def reduce_cols_by_key(x, keys, n_keys: int,
                       device: Optional[DeviceLike] = None,
                       res: Optional[Resources] = None) -> torch.Tensor:
    """Sum the columns of ``x`` (m, k) grouped by ``keys`` (k,) → (m,
    n_keys) in ``x``'s dtype."""
    dev = resolve_device(device, res)
    x = to_device(x, dev)
    return _segment_sum(x.T, to_device(keys, dev), int(n_keys)).T.to(x.dtype)


def bincount(keys, n_keys: int, weights=None, dtype=torch.float32,
             device: Optional[DeviceLike] = None,
             res: Optional[Resources] = None) -> torch.Tensor:
    """Histogram of integer keys over ``n_keys`` bins (``weights`` summed
    per key when given) in ``dtype``; keys outside ``[0, n_keys)`` count
    nowhere. Unweighted counts are exact integers."""
    dev = resolve_device(device, res)
    keys = to_device(keys, dev).reshape(-1).to(torch.int64)
    n_keys = int(n_keys)
    if weights is not None:
        w = to_device(weights, dev).reshape(-1, 1)
        return _segment_sum(w, keys, n_keys)[:, 0].to(dtype)
    valid = (keys >= 0) & (keys < n_keys)
    return torch.bincount(keys[valid], minlength=n_keys).to(dtype)


def matrix_vector_op(x, v, axis: int = 1, op: Callable = torch.add,
                     device: Optional[DeviceLike] = None,
                     res: Optional[Resources] = None) -> torch.Tensor:
    """``op(x, v)`` with ``v`` broadcast along the rows (``axis=1``: ``v``
    has one entry a column) or the columns (``axis=0``)."""
    dev = resolve_device(device, res)
    x, v = to_device(x, dev), to_device(v, dev)
    return op(x, v[None, :] if axis == 1 else v[:, None])


# -- random rotations ---------------------------------------------------------

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


def _flip_signs(u: torch.Tensor) -> torch.Tensor:
    """Per column of ``u``, the sign of its largest-|.| element (the first,
    on ties; +1 for a zero column)."""
    idx = torch.argmax(torch.abs(u), dim=0)
    signs = torch.sign(u[idx, torch.arange(u.shape[1], device=u.device)])
    return torch.where(signs == 0, torch.ones_like(signs), signs)


def sign_flip(u: torch.Tensor) -> torch.Tensor:
    """Deterministic sign convention: flip each column so its largest-|.|
    element (the first, on ties) is positive."""
    return u * _flip_signs(u)[None, :]


def _flipped(u: torch.Tensor, s: torch.Tensor, vt: torch.Tensor):
    """(u, s, vt) with each column of ``u`` and the matching row of ``vt``
    flipped together by :func:`sign_flip`'s sign: ``u·diag(s)·vt`` is
    unchanged."""
    signs = _flip_signs(u)
    r = min(u.shape[1], vt.shape[0])
    vt = torch.cat([vt[:r] * signs[:r, None], vt[r:]])
    return u * signs[None, :], s, vt


def eig_dc(a: torch.Tensor):
    """Symmetric eigendecomposition → (ascending eigenvalues, eigenvectors
    as columns under :func:`sign_flip`)."""
    w, v = torch.linalg.eigh(a)
    return w, sign_flip(v)


def svd(a, full_matrices: bool = False,
        device: Optional[DeviceLike] = None,
        res: Optional[Resources] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(u, s, vt) with ``u``'s columns under :func:`sign_flip` and ``vt``'s
    rows flipped alike, so that ``u·diag(s)·vt`` rebuilds ``a``."""
    a = _float(to_device(a, resolve_device(device, res)))
    return _flipped(*torch.linalg.svd(a, full_matrices=full_matrices))


def qr(a, device: Optional[DeviceLike] = None,
       res: Optional[Resources] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduced QR: ``q`` with orthonormal columns, ``r`` upper triangular
    (no sign convention, as in the JAX package)."""
    return torch.linalg.qr(_float(to_device(a, resolve_device(device, res))))


def lstsq(a, b, device: Optional[DeviceLike] = None,
          res: Optional[Resources] = None) -> torch.Tensor:
    """The minimum-norm least-squares solution of ``a·x = b`` through the
    SVD, singular values below ``eps·max(m, n)·s_max`` taken as zero
    (``jnp.linalg.lstsq``'s rule), so a rank-deficient ``a`` is solved
    too. ``b`` is (m,) or (m, k)."""
    dev = resolve_device(device, res)
    a, b = _float(to_device(a, dev)), _float(to_device(b, dev))
    if a.shape[0] != b.shape[0]:
        raise ValueError("Leading dimensions of input arrays must match")
    vec = b.ndim == 1
    if vec:
        b = b[:, None]
    m, n = a.shape
    rcond = float(torch.finfo(a.dtype).eps) * max(m, n)
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))[:, None]
    x = vt.T @ (s_inv * (u.T @ b))
    return x[:, 0] if vec else x


def rsvd(a, k: int, p: int = 10, n_iter: int = 4,
         generator: Optional[torch.Generator] = None,
         device: Optional[DeviceLike] = None,
         res: Optional[Resources] = None):
    """Randomized SVD: a Gaussian range finder of ``k + p`` columns
    (``omega`` drawn from ``generator`` on its own device, a seed-0
    generator on the run's device when none is given), ``n_iter`` power
    iterations with a QR each step, then the SVD of the small projection →
    rank-``k`` (u, s, vt), signs as :func:`svd`'s."""
    dev = resolve_device(device, res)
    a = _float(to_device(a, dev))
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    m, n = a.shape
    l_ = min(n, k + p)
    omega = torch.randn((n, l_), generator=generator, device=generator.device,
                        dtype=a.dtype).to(dev)
    q, _ = torch.linalg.qr(a @ omega)
    for _ in range(n_iter):
        q, _ = torch.linalg.qr(a.T @ q)
        q, _ = torch.linalg.qr(a @ q)
    ub, s, vt = torch.linalg.svd(q.T @ a, full_matrices=False)
    return _flipped((q @ ub)[:, :k], s[:k], vt[:k])


def lanczos(matvec_or_matrix, n_components: int, n: Optional[int] = None,
            max_iters: int = 0, seed: int = 0,
            device: Optional[DeviceLike] = None,
            res: Optional[Resources] = None):
    """Smallest eigenpairs of a symmetric operator by deflated Lanczos
    (:func:`raft_tpu_torch.sparse.solver.lanczos_smallest`): a CSR matrix
    (moved to the run's device), a dense (n, n) matrix, or a matvec
    callable (``n`` required) → (eigenvalues (k,), eigenvectors (n, k))."""
    from raft_tpu_torch.sparse.solver import lanczos_smallest
    from raft_tpu_torch.sparse.types import CSR

    dev = resolve_device(device, res)
    a = matvec_or_matrix
    if isinstance(a, CSR):
        a = CSR(a.indptr.to(dev), a.indices.to(dev), a.data.to(dev), a.shape)
        return lanczos_smallest(a, n_components, n=n, max_iters=max_iters,
                                seed=seed)
    if callable(a):
        return lanczos_smallest(a, n_components, n=n, max_iters=max_iters,
                                seed=seed, device=dev)
    dense = _float(to_device(a, dev))
    return lanczos_smallest(lambda v: dense @ v, n_components,
                            n=dense.shape[0], max_iters=max_iters, seed=seed,
                            device=dev)
