"""Precision settings of the reference, and the lower precisions of its
controls."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def highest_precision():
    """float32 products in float32: TF32 off for matmul and cuDNN inside
    the block, the settings restored after it."""
    mm, cudnn = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(prec)


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` (float32) rounded to the values ``precision`` holds, returned
    as float32: ``"tf32"`` keeps 10 mantissa bits (round to nearest, as
    the tensor cores convert), ``"bf16"`` 7, ``"fp8_e4m3"`` 3 (and the
    format's range)."""
    x = x.to(torch.float32)
    if precision == "fp32":
        return x
    if precision == "tf32":
        bits = x.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)
    if precision == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if precision == "fp8_e4m3":
        return x.to(torch.float8_e4m3fn).to(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")
