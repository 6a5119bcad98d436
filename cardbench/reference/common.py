"""What every reference and the check share, whatever the model:

- ``plain_fp32``: float32 matmuls in float32 on the card (TF32 off);
- ``fp8``: the control's rounding of a bfloat16 model's matmul operands;
- the streamed chunks' quantizer, the scheme the configurations state
  (``sparkv.quant_bits`` bits, groups of ``sparkv.quant_group``
  consecutive values): a group's codes are round((x - lo) / step), clipped
  to [0, 2^bits - 1], with lo its least value and step = max(hi - lo,
  1e-8) / (2^bits - 1); a code's value is code * step + lo.

Imports nothing of the program."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def plain_fp32():
    """float32 matmuls in float32 on the card: TF32 off for the block."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale that maps its largest
    magnitude to the format's largest finite value (448), back in
    float32."""
    s = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def quantize(x: torch.Tensor, bits: int, group: int):
    """x: float32, any shape whose size is a multiple of `group`. Returns
    (codes, step, lo): codes (n_groups, group) float32, step and lo
    (n_groups,) float32."""
    g = x.reshape(-1, group).float()
    lo = g.amin(1)
    span = torch.clamp(g.amax(1) - lo, min=1e-8)
    q = float((1 << bits) - 1)
    # true float32 divisions throughout: PyTorch divides by a Python
    # scalar as a multiplication by its reciprocal, a rounding off
    step = span / torch.full_like(span, q)
    codes = torch.clamp(torch.round((g - lo[:, None]) / step[:, None]),
                        0, q)
    return codes, step, lo


def dequantize(codes, step, lo) -> torch.Tensor:
    """Values of (codes, step, lo) in float64, shape (n_groups, group)."""
    return codes.double() * step.double()[:, None] + lo.double()[:, None]


def roundtrip(x: torch.Tensor, bits: int, group: int) -> torch.Tensor:
    """x quantized and dequantized, float32, x's shape."""
    return dequantize(*quantize(x, bits, group)).float().reshape(x.shape)
