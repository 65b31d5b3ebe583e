"""Published peaks, by the name ``torch.cuda.get_device_name()`` gives.

NVIDIA H100 SXM data sheet, dense (no sparsity), at the full 700 W power
limit: 989 TFLOP/s bf16 and fp16 on the tensor cores, 67 TFLOP/s float32
outside them, 3.35 TB/s of HBM3."""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "fp32_flops": 67e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def peaks(kind: str) -> Optional[dict]:
    """The peaks of the card named ``kind``; None for a card not listed."""
    return PEAKS.get(kind)


def least_seconds(flops: float, nbytes: float, pk: dict,
                  rate: str = "bf16_flops"):
    """(the least time the card could take, "operations" or "bytes": which
    of the two bounds it)."""
    t_ops = flops / pk[rate]
    t_bytes = nbytes / pk["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
