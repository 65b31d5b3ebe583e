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
``precision="highest"``, so fp32 products here stay full fp32.
"""

from raft_tpu_torch.core.resources import Resources, resolve_device

__all__ = ["Resources", "resolve_device"]
