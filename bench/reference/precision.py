"""Products of the reference, and the lower precisions of its control.

The reference computes every product in float32 with TF32 off. Its control
rounds the operands of each product first: to TF32 (10 mantissa bits,
round to nearest even) for a float32 model, or to fp8 e4m3 with one scale
per tensor (its largest magnitude onto 448) for a bfloat16 model. Rounding
is done on the values, so the control reads the same on any device.
"""
from __future__ import annotations

import torch

F32, TF32, FP8 = "f32", "tf32", "fp8"


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    # add half of the 13 dropped bits' unit, plus one for ties to even
    odd = (bits >> 13) & 1
    bits = (bits + 0xFFF + odd) & ~0x1FFF
    return bits.view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == F32:
        return x.float()
    if precision == TF32:
        return _tf32(x)
    if precision == FP8:
        return _fp8(x)
    raise ValueError(f"unknown precision {precision!r}")


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in float32 after rounding both operands."""
    return round_to(a, precision) @ round_to(b, precision)
