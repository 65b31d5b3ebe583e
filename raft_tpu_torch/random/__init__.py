"""Random generation (counterpart of ``raft_tpu/random``; reference
cpp/include/raft/random/).

The reference's counter-based Philox/PCG state (random/rng_state.hpp) and
the JAX package's splittable threefry keys become explicit
``torch.Generator`` objects seeded from the caller's seed: every draw takes
its generator as an argument, never the global one, so a seed gives the
same stream on every call. Draws are made on the CPU and moved to the
result's device, so a seed gives the same draws on ``cpu`` and ``cuda``;
the arithmetic over them and over the caller's tensors runs on the
result's device, and a tensor on the card never leaves it.
JAX's streams are not reproduced bit for bit; the generators hold the same
distributions and invariants: make_blobs (random/make_blobs.cuh:65),
make_regression, permute, sample_without_replacement, multi-variable
gaussian, and the RMAT rectangular graph generator
(random/rmat_rectangular_generator.cuh:81).
"""

from raft_tpu_torch.random.generators import (
    RngState,
    make_blobs,
    make_regression,
    multi_variable_gaussian,
    normal,
    permute,
    rmat,
    sample_without_replacement,
    uniform,
)

__all__ = [
    "RngState",
    "make_blobs",
    "make_regression",
    "multi_variable_gaussian",
    "permute",
    "rmat",
    "sample_without_replacement",
    "uniform",
    "normal",
]
