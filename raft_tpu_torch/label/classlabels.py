"""Monotonic label relabeling and label merging (counterpart of
``raft_tpu/label/classlabels.py``).

Each distinct label's dense rank comes from ``torch.unique(sorted=True)``
and its inverse map; the unique count is returned as a 0-d tensor, as the
JAX package returns a traced scalar.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import DeviceLike, resolve_device


def _labels(labels, device: Optional[DeviceLike] = None) -> torch.Tensor:
    """An integer tensor: a tensor keeps its device, host data goes to
    ``device`` (``cuda`` unless the caller asks for the CPU)."""
    if isinstance(labels, torch.Tensor):
        t = labels if device is None else labels.to(resolve_device(device))
    else:
        t = torch.as_tensor(np.asarray(labels), device=resolve_device(device))
    if t.is_floating_point() or t.dtype == torch.bool:
        t = t.to(torch.int32)
    return t


def make_monotonic(labels, ignore_value: Optional[int] = None,
                   device: Optional[DeviceLike] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relabel integer labels to dense 0..n_unique-1 in sorted order →
    (monotonic (n,) int32, n_unique 0-d int32). Entries equal to
    ``ignore_value`` become -1 and count as no class."""
    labels = _labels(labels, device)
    if labels.ndim != 1:
        raise ValueError(f"labels must be 1-D, got {tuple(labels.shape)}")
    if ignore_value is not None:
        big = torch.iinfo(labels.dtype).max
        ignored = labels == ignore_value
        work = torch.where(ignored, big, labels)
    else:
        work = labels
    uniq, inverse = torch.unique(work, sorted=True, return_inverse=True)
    n_unique = uniq.numel()
    if ignore_value is not None:
        n_unique -= int((uniq == big).sum())
        # the JAX package's sentinel is the dtype's max: a real label equal
        # to it takes the largest other class's rank (-1 if none), as there
        inverse = torch.where(ignored, -1,
                              torch.where(work == big, inverse - 1, inverse))
    return inverse.to(torch.int32), torch.tensor(n_unique, dtype=torch.int32,
                                                 device=labels.device)


def get_classes(labels, device: Optional[DeviceLike] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted distinct labels padded to n with the largest class →
    (classes (n,), n_unique 0-d int32)."""
    labels = _labels(labels, device)
    uniq = torch.unique(labels, sorted=True)
    n = labels.shape[0]
    pad = uniq[-1:].expand(n - uniq.numel())
    return torch.cat([uniq, pad]), torch.tensor(uniq.numel(),
                                                dtype=torch.int32,
                                                device=labels.device)


def merge_labels(labels_a, labels_b,
                 device: Optional[DeviceLike] = None) -> torch.Tensor:
    """Merge two labelings: elements sharing a label in either input end up
    with the same output label (connected components over the bipartite
    label graph, by min-representative sweeps to a fixpoint; one host read
    a sweep)."""
    a = _labels(labels_a, device).to(torch.int32)
    b = _labels(labels_b, a.device).to(torch.int32)
    if a.shape != b.shape or a.ndim != 1:
        raise ValueError("labels_a/labels_b must be equal-length 1-D arrays")
    a = make_monotonic(a)[0].long()
    b = make_monotonic(b)[0].long()
    n = a.shape[0]
    big = torch.iinfo(torch.int32).max
    rep = torch.arange(n, dtype=torch.int32, device=a.device)
    while True:
        min_a = torch.full((n,), big, dtype=torch.int32, device=a.device
                           ).scatter_reduce(0, a, rep, "amin",
                                            include_self=False)
        min_b = torch.full((n,), big, dtype=torch.int32, device=a.device
                           ).scatter_reduce(0, b, rep, "amin",
                                            include_self=False)
        new = torch.minimum(rep, torch.minimum(min_a[a], min_b[b]))
        changed = bool((new != rep).any())
        rep = new
        if not changed:
            break
    return make_monotonic(rep)[0]
