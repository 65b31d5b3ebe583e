"""Quality metrics (counterpart of ``raft_tpu/stats/metrics.py``).

The clustering comparisons all read one contingency matrix, here
``bincount(t·n_pred + p)``: exact integer counts, with no (n × classes)
one-hot. The metrics computed from counts run in float64 (pair counts at
1M rows are exact there) and return float32 as the JAX package does.
``silhouette_score`` tiles its distance rows as the JAX package does;
``trustworthiness_score`` ranks with stable sorts (the lowest index first
at ties, as ``jnp.argsort`` and ``lax.top_k`` order them). Every entry
point added here takes ``device=None, res=None`` and moves its operands to
the resolved device.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.resources import (DeviceLike, Resources,
                                           resolve_device, resources_for,
                                           to_device)
from raft_tpu_torch.ops import distance as dist_mod


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def accuracy(predictions, references, device: Optional[DeviceLike] = None,
             res: Optional[Resources] = None) -> torch.Tensor:
    """Fraction of exact matches (float32)."""
    dev = resolve_device(device, res)
    p, r = to_device(predictions, dev), to_device(references, dev)
    return torch.mean((p == r).to(torch.float64)).to(torch.float32)


def contingency_matrix(labels_true, labels_pred,
                       n_classes_true: Optional[int] = None,
                       n_classes_pred: Optional[int] = None,
                       device: Optional[DeviceLike] = None,
                       res: Optional[Resources] = None) -> torch.Tensor:
    """(n_classes_true, n_classes_pred) int32 co-occurrence counts; the
    class counts default to each labelling's max + 1, and a label outside
    its range counts nowhere (as a one-hot row of zeros does)."""
    dev = resolve_device(device, res)
    t = to_device(labels_true, dev).reshape(-1).to(torch.int64)
    p = to_device(labels_pred, dev).reshape(-1).to(torch.int64)
    nt = int(n_classes_true) if n_classes_true else int(t.max()) + 1
    np_ = int(n_classes_pred) if n_classes_pred else int(p.max()) + 1
    ok = (t >= 0) & (t < nt) & (p >= 0) & (p < np_)
    cells = torch.bincount((t * np_ + p)[ok], minlength=nt * np_)
    return cells.reshape(nt, np_).to(torch.int32)


def _counts(labels_true, labels_pred, device, res) -> torch.Tensor:
    return contingency_matrix(labels_true, labels_pred, device=device,
                              res=res).to(torch.float64)


def rand_index(labels_true, labels_pred, device: Optional[DeviceLike] = None,
               res: Optional[Resources] = None) -> torch.Tensor:
    """Rand index: the fraction of element pairs both labellings put
    together or both put apart."""
    c = _counts(labels_true, labels_pred, device, res)
    n = c.sum()
    sum_sq = (c * c).sum()
    sum_rows = (c.sum(1) ** 2).sum()
    sum_cols = (c.sum(0) ** 2).sum()
    a = (sum_sq - n) / 2.0
    b = (n * n + sum_sq - sum_rows - sum_cols) / 2.0
    return _f32((a + b) / (n * (n - 1.0) / 2.0))


def _comb2(x: torch.Tensor) -> torch.Tensor:
    return x * (x - 1.0) / 2.0


def adjusted_rand_index(labels_true, labels_pred,
                        device: Optional[DeviceLike] = None,
                        res: Optional[Resources] = None) -> torch.Tensor:
    """The Rand index adjusted for chance (1.0 where both labellings are
    trivially equal)."""
    c = _counts(labels_true, labels_pred, device, res)
    sum_comb = _comb2(c).sum()
    sum_a = _comb2(c.sum(1)).sum()
    sum_b = _comb2(c.sum(0)).sum()
    expected = sum_a * sum_b / _comb2(c.sum())
    denom = (sum_a + sum_b) / 2.0 - expected
    return _f32(torch.where(denom == 0, torch.ones_like(denom),
                            (sum_comb - expected) / denom))


def _mutual_info(c: torch.Tensor) -> torch.Tensor:
    pij = c / c.sum()
    pi = pij.sum(1, keepdim=True)
    pj = pij.sum(0, keepdim=True)
    ratio = torch.where(pij > 0, pij / (pi * pj), torch.ones_like(pij))
    return (pij * torch.log(ratio)).sum()


def mutual_info_score(labels_true, labels_pred,
                      device: Optional[DeviceLike] = None,
                      res: Optional[Resources] = None) -> torch.Tensor:
    """Mutual information (nats) between two labellings."""
    return _f32(_mutual_info(_counts(labels_true, labels_pred, device, res)))


def _entropy(counts: torch.Tensor) -> torch.Tensor:
    p = counts / counts.sum()
    return -(p * torch.log(torch.where(p > 0, p, torch.ones_like(p)))).sum()


def _homogeneity(c: torch.Tensor) -> torch.Tensor:
    h_c = _entropy(c.sum(1))
    return torch.where(h_c == 0, torch.ones_like(h_c), _mutual_info(c) / h_c)


def homogeneity_score(labels_true, labels_pred,
                      device: Optional[DeviceLike] = None,
                      res: Optional[Resources] = None) -> torch.Tensor:
    """``I(C; K) / H(C)`` (1.0 when ``H(C)`` is 0)."""
    return _f32(_homogeneity(_counts(labels_true, labels_pred, device, res)))


def completeness_score(labels_true, labels_pred,
                       device: Optional[DeviceLike] = None,
                       res: Optional[Resources] = None) -> torch.Tensor:
    """``I(C; K) / H(K)``: homogeneity with the labellings swapped."""
    return homogeneity_score(labels_pred, labels_true, device, res)


def v_measure(labels_true, labels_pred, beta: float = 1.0,
              device: Optional[DeviceLike] = None,
              res: Optional[Resources] = None) -> torch.Tensor:
    """Weighted harmonic mean of homogeneity and completeness."""
    c = _counts(labels_true, labels_pred, device, res)
    h, k = _homogeneity(c), _homogeneity(c.T)
    denom = beta * h + k
    return _f32(torch.where(denom == 0, torch.zeros_like(denom),
                            (1 + beta) * h * k / denom))


def r2_score(y, y_hat, device: Optional[DeviceLike] = None,
             res: Optional[Resources] = None) -> torch.Tensor:
    """Coefficient of determination ``1 − SS_res / SS_tot``."""
    dev = resolve_device(device, res)
    y = to_device(y, dev).to(torch.float32).to(torch.float64)
    y_hat = to_device(y_hat, dev).to(torch.float32).to(torch.float64)
    ss_res = ((y - y_hat) ** 2).sum()
    ss_tot = ((y - y.mean()) ** 2).sum()
    return _f32(1.0 - ss_res / ss_tot)


def _median(x: torch.Tensor) -> torch.Tensor:
    """The median of a 1-D tensor, the mean of the two middle values when
    the count is even (``jnp.median``; ``torch.median`` takes the lower)."""
    s = torch.sort(x).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) / 2


def regression_metrics(predictions, references,
                       device: Optional[DeviceLike] = None,
                       res: Optional[Resources] = None):
    """(mean absolute error, mean squared error, median absolute error),
    float32."""
    dev = resolve_device(device, res)
    err = to_device(predictions, dev).to(torch.float32) \
        - to_device(references, dev).to(torch.float32)
    e64 = err.to(torch.float64)
    return (_f32(e64.abs().mean()), _f32((e64 * e64).mean()),
            _median(err.abs()))


def silhouette_score(x, labels, n_classes: int, metric: str = "sqeuclidean",
                     tile_rows: int = 2048,
                     device: Optional[DeviceLike] = None,
                     res: Optional[Resources] = None) -> torch.Tensor:
    """Mean silhouette coefficient. Per tile of ``tile_rows`` rows: the
    distances to every row, reduced against the cluster one-hot by one fp32
    product into per-cluster sums; ``a`` the own cluster's mean (self
    excluded), ``b`` the best other cluster's, ``s = (b − a) / max(a, b)``;
    singleton clusters score 0."""
    res = resources_for(device, res)
    dev = res.device
    x = to_device(x, dev).to(torch.float32)
    lab = to_device(labels, dev).reshape(-1).to(torch.int64)
    n = x.shape[0]
    classes = torch.arange(n_classes, device=dev)
    onehot = (lab[:, None] == classes[None, :]).to(torch.float32)
    counts = onehot.sum(0)
    scores = []
    for start in range(0, n, tile_rows):
        xb = x[start:start + tile_rows]
        lb = lab[start:start + tile_rows]
        d = dist_mod.pairwise_distance(xb, x, metric=metric, res=res)
        csum = d @ onehot
        own = counts[lb]
        a = csum[torch.arange(xb.shape[0], device=dev), lb] \
            / torch.clamp(own - 1, min=1)
        other = torch.where((classes[None, :] == lb[:, None])
                            | (counts[None, :] == 0), float("inf"),
                            csum / torch.clamp(counts[None, :], min=1))
        b = other.min(1).values
        scores.append(torch.where(
            own > 1, (b - a) / torch.clamp(torch.maximum(a, b), min=1e-30),
            torch.zeros_like(a)))
    return _f32(torch.cat(scores).to(torch.float64).mean())


def trustworthiness_score(x, x_embedded, n_neighbors: int,
                          metric: str = "sqeuclidean", batch_size: int = 512,
                          device: Optional[DeviceLike] = None,
                          res: Optional[Resources] = None) -> torch.Tensor:
    """How well an embedding keeps local structure: ``1 − 2/(n·k·(2n − 3k −
    1))·Σ max(r − k + 1, 0)`` over each row's k nearest rows in the
    embedding, ``r`` their rank (0 = nearest, self excluded) in the
    original space."""
    res = resources_for(device, res)
    dev = res.device
    x = to_device(x, dev).to(torch.float32)
    e = to_device(x_embedded, dev).to(torch.float32)
    n = x.shape[0]
    k = int(n_neighbors)
    penalty = torch.zeros((), dtype=torch.float64, device=dev)
    for start in range(0, n, batch_size):
        xb, eb = x[start:start + batch_size], e[start:start + batch_size]
        b = xb.shape[0]
        rows = torch.arange(b, device=dev)
        d_orig = dist_mod.pairwise_distance(xb, x, metric=metric, res=res)
        d_orig[rows, start + rows] = float("inf")
        order = torch.argsort(d_orig, dim=1, stable=True)
        ranks = torch.empty_like(order)
        ranks.scatter_(1, order, torch.arange(n, device=dev).expand(b, n))
        d_emb = dist_mod.pairwise_distance(eb, e, metric=metric, res=res)
        d_emb[rows, start + rows] = float("inf")
        knn = torch.argsort(d_emb, dim=1, stable=True)[:, :k]
        r = torch.gather(ranks, 1, knn)
        penalty += torch.clamp(r - k + 1, min=0).sum().to(torch.float64)
    return _f32(1.0 - penalty * (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0))))


def neighborhood_recall(indices, ref_indices, distances=None,
                        ref_distances=None, eps: float = 0.001) -> float:
    """Recall of ANN results against ground truth: a column matches when
    its id is in the reference row or, with distances, when some reference
    distance is within relative ``eps`` (absolute below ``eps``). Rows are
    compared in tiles, so 10k × 10 results need no (q, k, k) block at once."""
    idx = torch.as_tensor(indices)
    ref = torch.as_tensor(ref_indices).to(idx.device)
    if idx.shape[0] != ref.shape[0]:
        raise ValueError("indices and ref_indices must have the same row count")
    if (distances is None) != (ref_distances is None):
        raise ValueError("distances and ref_distances must be provided together")
    hits = 0.0
    step = 4096
    for s in range(0, idx.shape[0], step):
        match = (idx[s:s + step, :, None] == ref[s:s + step, None, :]).any(2)
        if distances is not None:
            d = torch.as_tensor(distances).to(idx.device)[s:s + step, :, None]
            rd = torch.as_tensor(ref_distances).to(idx.device)[s:s + step, None, :]
            diff = (d - rd).abs()
            m = torch.maximum(d.abs(), rd.abs())
            ratio = torch.where(diff > eps, diff / m.clamp(min=1e-30), diff)
            match = match | (ratio <= eps).any(2)
        hits += float(match.to(torch.float32).sum())
    return hits / float(idx.numel())


def topk_agreement(v_ref: torch.Tensor, i_ref: torch.Tensor,
                   v_got: torch.Tensor, i_got: torch.Tensor,
                   rtol: float = 5e-4, atol: float = 0.0,
                   tie_rtol: float = 1e-3, max_mismatch: float = 0.05,
                   mask: Optional[torch.Tensor] = None) -> dict:
    """How far two ascending per-row top-k results agree when they should
    differ only by the order of fp32 sums: the ±inf pattern, finite values
    within ``atol + rtol·|v|``, and ids equal except at near-ties — a
    position may hold another id only where the two values there agree
    within ``atol + tie_rtol·|v|`` (two candidates that tie), and on at
    most a ``max_mismatch`` share of the positions, so that right values
    under wrong ids cannot pass. ``mask`` (rows) limits the comparison.
    Returns counts and worst errors; ``ok`` is their verdict."""
    if mask is not None:
        v_ref, i_ref, v_got, i_got = (t[mask] for t in (v_ref, i_ref, v_got, i_got))
    v_ref, v_got = v_ref.double(), v_got.double()
    fin = torch.isfinite(v_ref)
    same_inf = bool(((~fin) == ~torch.isfinite(v_got)).all()
                    and (v_ref[~fin] == v_got[~fin]).all())
    err = (v_ref[fin] - v_got[fin]).abs()
    scale = v_ref[fin].abs()
    vals_ok = bool((err <= atol + rtol * scale).all()) if fin.any() else True
    diff_id = (i_ref != i_got) & fin
    tie = (v_ref - v_got).abs() <= atol + tie_rtol * v_ref.abs()
    unexplained = int((diff_id & ~tie).sum())
    n = max(1, int(fin.sum()))
    return {
        "ok": (same_inf and vals_ok and unexplained == 0
               and int(diff_id.sum()) <= max_mismatch * n),
        "same_inf": same_inf,
        "values_ok": vals_ok,
        "max_abs_err": float(err.max()) if err.numel() else 0.0,
        "max_rel_err": float((err / scale.clamp(min=1e-30)).max())
        if err.numel() else 0.0,
        "id_mismatch_frac": int(diff_id.sum()) / n,
        "unexplained_id_mismatches": unexplained,
        "compared": int(fin.sum()),
    }
