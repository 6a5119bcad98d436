"""Gradient compression for the data-parallel all-reduce: int8 quantized
gradients with error feedback (EF-SGD style), on ``torch.distributed``.

Port of ``repro/training/compression.py``, where it runs inside
shard_map: local grads are quantized with a scale shared across the
group (an all-reduce MAX), the int32 codes are summed (an all-reduce
SUM) and dequantized; the quantization residual is carried to the next
step. Nothing calls it yet, in the reference or here
(``TrainConfig.grad_compression`` is read nowhere).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import flatten, leaves, tree_map, unflatten


def _quant_int8(g):
    a = torch.max(torch.abs(g)) + 1e-12
    scale = a / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_int8(q, scale):
    return q.float() * scale


def compressed_psum(grads, error_state, group=None):
    """Per-leaf int8 quantize -> all-reduce -> dequant, with error
    feedback, over the process group `group` (default: the world).
    Returns (mean grads, new error state)."""
    n = dist.get_world_size(group)

    def one(g, e):
        gf = g.float() + e
        # shared scale across the group so the int32 reduction is exact
        scale = (torch.max(torch.abs(gf)) + 1e-12) / 127.0
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q = torch.clamp(torch.round(gf / scale), -127, 127)
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        avg = total.float() * scale / n
        return avg.to(g.dtype), gf - q * scale

    flat_g, treedef = flatten(grads)
    out = [one(g, e) for g, e in zip(flat_g, leaves(error_state))]
    return (unflatten(treedef, [o[0] for o in out]),
            unflatten(treedef, [o[1] for o in out]))


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
