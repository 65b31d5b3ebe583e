"""raft_tpu_torch — the PyTorch/CUDA port of raft_tpu for one NVIDIA H100.

Module paths mirror ``raft_tpu`` one for one (``raft_tpu_torch/ops/strip_scan.py``
is the counterpart of ``raft_tpu/ops/strip_scan.py``), and function names
follow the JAX package where a reader needs to pair them. Plain tensor code
is PyTorch; the TPU's Pallas kernels become hand-written Hopper kernels under
``ops/csrc/``, each with a plain PyTorch twin in the same module.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"`` or ``Resources(device="cpu")``); with no card and no CPU
request they raise ``RuntimeError`` instead of falling back.

Importing this package disables TF32 for fp32 matmuls and convolutions
(:mod:`raft_tpu_torch.core.resources`): the reference's primitives run at
``precision="highest"``, so fp32 products here stay full fp32. The
subpackages load on first access (``raft_tpu_torch.stats``), so the import
itself stays light and touches no CUDA context.
"""

__version__ = "0.2.0"

from raft_tpu_torch._lazy import attach
from raft_tpu_torch.core.resources import (Resources, current_resources,
                                           resolve_device, use_resources)

_SUBPACKAGES = ("cluster", "comms", "distributed", "label", "neighbors",
                "obs", "ops", "random", "resilience", "solver", "sparse",
                "spectral", "stats")

__getattr__, __dir__ = attach(__name__, {n: (n, None) for n in _SUBPACKAGES})

__all__ = list(_SUBPACKAGES) + [
    "Resources", "current_resources", "use_resources", "__version__",
    # port-only: the device rule every entry point follows
    "resolve_device",
]
