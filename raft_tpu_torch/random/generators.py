"""RNG state + dataset/graph generators (counterpart of
``raft_tpu/random/generators.py``) — see the package docstring.

Every function takes ``key_or_seed``: an int seed, a ``torch.Generator``
(used as is, and advanced), or an :class:`RngState` (split once). Results
land on ``device`` / ``res.device`` — ``cuda`` unless the caller asks for
the CPU. Only the draws are made on the host (a CPU generator's stream);
they move to the result's device, and every operation on them and on the
caller's tensors (``centers``, ``mean``, ``cov``, ``theta``) runs there:
a tensor on the card is never fetched to the host."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.resources import DeviceLike, Resources, resolve_device

#: the largest seed a split hands a child generator (63 bits: manual_seed
#: takes any non-negative int64)
_SEED_MAX = (1 << 63) - 1


class RngState:
    """Stateful convenience wrapper over one ``torch.Generator`` (the analog
    of the mutable rng_state handed through reference APIs,
    random/rng_state.hpp:28): :meth:`split` draws a child seed from it and
    returns a fresh generator, so consecutive splits give independent,
    reproducible streams."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.generator = torch.Generator().manual_seed(self.seed)

    def split(self) -> torch.Generator:
        child = int(torch.randint(0, _SEED_MAX, (1,), dtype=torch.int64,
                                  generator=self.generator))
        return torch.Generator().manual_seed(child)


def _as_generator(key_or_seed) -> torch.Generator:
    if isinstance(key_or_seed, RngState):
        return key_or_seed.split()
    if isinstance(key_or_seed, torch.Generator):
        return key_or_seed
    return torch.Generator().manual_seed(int(key_or_seed))


def _split(gen: torch.Generator, n: int) -> list:
    """``n`` child generators seeded from ``gen`` (jax.random.split's role)."""
    seeds = torch.randint(0, _SEED_MAX, (n,), dtype=torch.int64,
                          generator=gen)
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


def uniform(key_or_seed, shape, low=0.0, high=1.0, dtype=torch.float32,
            res: Optional[Resources] = None,
            device: Optional[DeviceLike] = None) -> torch.Tensor:
    """Uniform draws in ``[low, high)``."""
    dev = resolve_device(device, res)
    u = torch.rand(tuple(shape), dtype=dtype,
                   generator=_as_generator(key_or_seed)).to(dev)
    return low + (high - low) * u


def normal(key_or_seed, shape, mean=0.0, std=1.0, dtype=torch.float32,
           res: Optional[Resources] = None,
           device: Optional[DeviceLike] = None) -> torch.Tensor:
    """Gaussian draws with the given mean and standard deviation."""
    dev = resolve_device(device, res)
    z = torch.randn(tuple(shape), dtype=dtype,
                    generator=_as_generator(key_or_seed)).to(dev)
    return mean + std * z


def permute(key_or_seed, n: int, res: Optional[Resources] = None,
            device: Optional[DeviceLike] = None) -> torch.Tensor:
    """Random permutation of [0, n) as int32 (random/permute.cuh analog)."""
    dev = resolve_device(device, res)
    perm = torch.randperm(int(n), generator=_as_generator(key_or_seed))
    return perm.to(torch.int32).to(dev)


def sample_without_replacement(key_or_seed, n_population: int,
                               n_samples: int,
                               res: Optional[Resources] = None,
                               device: Optional[DeviceLike] = None
                               ) -> torch.Tensor:
    """Uniform sample of ``n_samples`` distinct ids from [0, n_population)
    as int32 (random/sample_without_replacement.cuh analog)."""
    if not 0 <= int(n_samples) <= int(n_population):
        raise ValueError(f"cannot draw {n_samples} distinct ids from "
                         f"{n_population}")
    dev = resolve_device(device, res)
    perm = torch.randperm(int(n_population),
                          generator=_as_generator(key_or_seed))
    return perm[:int(n_samples)].to(torch.int32).to(dev)


def make_blobs(
    key_or_seed,
    n_rows: int,
    n_cols: int,
    n_clusters: int = 5,
    cluster_std: float = 1.0,
    center_box: Tuple[float, float] = (-10.0, 10.0),
    centers=None,
    dtype=torch.float32,
    res: Optional[Resources] = None,
    device: Optional[DeviceLike] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Isotropic Gaussian blobs: (data (n_rows, n_cols), labels int32,
    centers) (random/make_blobs.cuh:65 analog). Centers are uniform in
    ``center_box`` unless given; each row is its label's center plus
    ``cluster_std`` Gaussian noise."""
    dev = resolve_device(device, res)
    g_centers, g_labels, g_noise = _split(_as_generator(key_or_seed), 3)
    if centers is None:
        lo, hi = float(center_box[0]), float(center_box[1])
        centers = lo + (hi - lo) * torch.rand(
            (int(n_clusters), int(n_cols)), dtype=dtype,
            generator=g_centers).to(dev)
    else:
        centers = torch.as_tensor(centers).to(dev, dtype)
        n_clusters = centers.shape[0]
    labels = torch.randint(0, int(n_clusters), (int(n_rows),),
                           generator=g_labels).to(dev, torch.int32)
    noise = torch.randn((int(n_rows), int(n_cols)), dtype=dtype,
                        generator=g_noise).to(dev)
    data = centers[labels.long()] + cluster_std * noise
    return data, labels, centers


def make_regression(
    key_or_seed,
    n_rows: int,
    n_cols: int,
    n_informative: Optional[int] = None,
    n_targets: int = 1,
    bias: float = 0.0,
    noise: float = 0.0,
    dtype=torch.float32,
    res: Optional[Resources] = None,
    device: Optional[DeviceLike] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Linear-model regression data: (X, y, coef)
    (random/make_regression.cuh analog): Gaussian X, the first
    ``n_informative`` coefficient rows uniform in [0, 100), the rest 0."""
    dev = resolve_device(device, res)
    g_x, g_w, g_n = _split(_as_generator(key_or_seed), 3)
    n_informative = n_cols if n_informative is None else int(n_informative)
    x = torch.randn((int(n_rows), int(n_cols)), dtype=dtype,
                    generator=g_x).to(dev)
    coef = torch.zeros((int(n_cols), int(n_targets)), dtype=dtype)
    coef[:n_informative] = 100.0 * torch.rand(
        (n_informative, int(n_targets)), dtype=dtype, generator=g_w)
    coef = coef.to(dev)
    y = x @ coef + bias
    if noise > 0:
        y = y + noise * torch.randn(tuple(y.shape), dtype=dtype,
                                    generator=g_n).to(dev)
    return x, y.squeeze(), coef.squeeze()


def multi_variable_gaussian(key_or_seed, mean, cov, n_samples: int,
                            res: Optional[Resources] = None,
                            device: Optional[DeviceLike] = None
                            ) -> torch.Tensor:
    """Samples from N(mean, cov) via Cholesky
    (random/multi_variable_gaussian.cuh), in ``mean``'s dtype."""
    dev = resolve_device(device, res)
    mean = torch.as_tensor(mean).to(dev)
    dtype = mean.dtype if mean.is_floating_point() else torch.float32
    chol = torch.linalg.cholesky(torch.as_tensor(cov).to(dev, torch.float64))
    z = torch.randn((int(n_samples), mean.shape[0]), dtype=torch.float64,
                    generator=_as_generator(key_or_seed)).to(dev)
    out = mean.to(torch.float64)[None, :] + z @ chol.T
    return out.to(dtype)


def rmat(
    key_or_seed,
    r_scale: int,
    c_scale: int,
    n_edges: int,
    theta=None,
    res: Optional[Resources] = None,
    device: Optional[DeviceLike] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RMAT rectangular graph generator: edge list (rows, cols) int32 in a
    2^r_scale × 2^c_scale vertex space
    (random/rmat_rectangular_generator.cuh:81).

    ``theta`` is (max(r_scale, c_scale), 4) per-level quadrant
    probabilities (a, b, c, d), each row normalised; default the standard
    (0.57, 0.19, 0.19, 0.05) at every level. Each level draws one quadrant
    an edge: c and d set the row bit, b and d the column bit, while the
    level is below that side's scale: a uniform draw picks the quadrant
    whose interval of the level's cumulative probabilities holds it."""
    dev = resolve_device(device, res)
    max_scale = max(int(r_scale), int(c_scale))
    if theta is None:
        theta = torch.tensor([[0.57, 0.19, 0.19, 0.05]], dtype=torch.float64,
                             device=dev).repeat(max_scale, 1)
    else:
        theta = torch.as_tensor(theta).to(dev, torch.float64).reshape(
            max_scale, 4)
    cdf = torch.cumsum(theta, dim=1)
    cdf = cdf[:, :3] / cdf[:, 3:]
    gens = _split(_as_generator(key_or_seed), max_scale)
    rows = torch.zeros(int(n_edges), dtype=torch.int64, device=dev)
    cols = torch.zeros(int(n_edges), dtype=torch.int64, device=dev)
    for lvl in range(max_scale):
        u = torch.rand(int(n_edges), dtype=torch.float64,
                       generator=gens[lvl]).to(dev)
        q = (u[:, None] >= cdf[lvl][None, :]).sum(dim=1)
        if lvl < r_scale:
            rows = rows * 2 + (q >= 2).to(torch.int64)
        if lvl < c_scale:
            cols = cols * 2 + (q % 2)
    return rows.to(torch.int32), cols.to(torch.int32)
