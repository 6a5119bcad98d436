"""Oracle for fused KV dequantization: uint8 codes + per-group scale/zero
-> out_dtype, matching repro_torch.compression.quantize semantics.

Written as the reference oracle is, with a separate multiply and add
(two roundings), so it equals ``repro.kernels.kv_dequant.ref`` bit for
bit. The kernels and their plain versions round once (fma); they agree
with this oracle to within one fp32 ulp of the result.
"""
from __future__ import annotations

import torch


def kv_dequant_ref(codes, scales, zeros, *, group: int,
                   out_dtype=torch.bfloat16):
    """codes: (n, g*group) uint8 laid out as g groups of `group` values per
    row; scales/zeros: (n, g) float32. Returns (n, g*group) out_dtype."""
    n, width = codes.shape
    g = width // group
    c = codes.to(torch.float32).reshape(n, g, group)
    x = c * scales[..., None] + zeros[..., None]
    return x.reshape(n, width).to(out_dtype)


def kv_dequant_mixed_ref(codes, spans, zeros, bits, *, group: int,
                         out_dtype=torch.bfloat16):
    """Mixed-bitwidth oracle: per-row `bits` (n, 1) int32 selects the
    scale interpretation spans / (2^bits - 1); otherwise identical to
    kv_dequant_ref."""
    n, width = codes.shape
    g = width // group
    c = codes.to(torch.float32).reshape(n, g, group)
    q = ((1 << bits.to(torch.int32)) - 1).to(torch.float32)
    step = spans / q
    x = c * step[..., None] + zeros[..., None]
    return x.reshape(n, width).to(out_dtype)
