"""Wrapper: QuantizedTensor (wire format) -> KV tensor on a device, via
the fused dequant kernel on CUDA and its plain version on the CPU.

The row packing is the reference's (``repro/kernels/kv_dequant/ops.py``):
whole groups per row, at most 8 groups a row, pad groups with step
(span) 1 and zero 0.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.compression.quantize import QuantizedTensor
from repro_torch.device import resolve
from repro_torch.kernels.kv_dequant import kernel as K


def kv_dequant(codes, scales, zeros, *, group: int,
               out_dtype=torch.bfloat16):
    """Dispatch on the tensors' device: the CUDA kernel on the card, the
    plain version on the CPU, an error anywhere else."""
    if codes.device.type == "cuda":
        return K.kv_dequant(codes, scales, zeros, group=group,
                            out_dtype=out_dtype)
    if codes.device.type == "cpu":
        return K.kv_dequant_plain(codes, scales, zeros, group=group,
                                  out_dtype=out_dtype)
    raise ValueError(f"no kv_dequant for device {codes.device}")


def kv_dequant_mixed(codes, spans, zeros, bits, *, group: int,
                     out_dtype=torch.bfloat16):
    """Mixed-bitwidth form of :func:`kv_dequant`, same dispatch."""
    if codes.device.type == "cuda":
        return K.kv_dequant_mixed(codes, spans, zeros, bits, group=group,
                                  out_dtype=out_dtype)
    if codes.device.type == "cpu":
        return K.kv_dequant_mixed_plain(codes, spans, zeros, bits,
                                        group=group, out_dtype=out_dtype)
    raise ValueError(f"no kv_dequant_mixed for device {codes.device}")


def _pack(qt: QuantizedTensor, gpr: int, params: np.ndarray):
    """(codes (rows, gpr*group) u8, params (rows, gpr), zeros (rows, gpr))
    with the tail padded by whole groups of step 1, zero 0."""
    n_vals = int(np.prod(qt.shape))
    group = qt.group
    g_total = qt.scales.shape[0]
    codes = np.zeros(g_total * group, np.uint8)
    codes[:n_vals] = qt.codes
    rows = -(-g_total // gpr)
    pad_g = rows * gpr - g_total
    codes = codes.reshape(g_total, group)
    zeros = qt.zeros
    if pad_g:
        codes = np.concatenate([codes, np.zeros((pad_g, group), np.uint8)])
        params = np.concatenate([params, np.ones(pad_g, np.float32)])
        zeros = np.concatenate([zeros, np.zeros(pad_g, np.float32)])
    return (codes.reshape(rows, gpr * group),
            params.astype(np.float32).reshape(rows, gpr),
            zeros.astype(np.float32).reshape(rows, gpr))


def _to(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def dequantize_chunk(qt: QuantizedTensor, *, out_dtype=torch.bfloat16,
                     device=None) -> torch.Tensor:
    """Dequantize a streamed KV chunk on `device` (default: the card).
    Returns a qt.shape tensor."""
    dev = resolve(device)
    n_vals = int(np.prod(qt.shape))
    gpr = max(1, min(8, qt.scales.shape[0]))
    codes, scales, zeros = _to(dev, *_pack(qt, gpr, qt.scales))
    out = kv_dequant(codes, scales, zeros, group=qt.group,
                     out_dtype=out_dtype)
    return out.reshape(-1)[:n_vals].reshape(qt.shape)


def _spans_of(qt: QuantizedTensor) -> np.ndarray:
    if qt.spans is not None:
        return qt.spans
    # pre-spans tensors: reconstruct (scales were span / (2^bits - 1))
    return (qt.scales * np.float32((1 << qt.bits) - 1)).astype(np.float32)


def dequantize_chunks_mixed(qts: list, *, out_dtype=torch.bfloat16,
                            device=None) -> list:
    """Dequantize many streamed KV chunks of heterogeneous bit-widths in
    ONE kernel launch. All chunks must share the quantization group size;
    each chunk's groups are packed into rows carrying that chunk's
    bit-width in the per-row bits plane. Returns one qt.shape tensor per
    input, each exactly equal (in fp32) to its `dequantize_chunk`."""
    assert qts, "empty chunk list"
    dev = resolve(device)
    group = qts[0].group
    assert all(q.group == group for q in qts), "heterogeneous group size"
    gpr = max(1, min(8, max(q.scales.shape[0] for q in qts)))
    codes_rows, span_rows, zero_rows, bits_rows = [], [], [], []
    for qt in qts:
        codes, spans, zeros = _pack(qt, gpr, _spans_of(qt))
        codes_rows.append(codes)
        span_rows.append(spans)
        zero_rows.append(zeros)
        bits_rows.append(np.full((codes.shape[0], 1), qt.bits, np.int32))
    starts = np.cumsum([0] + [c.shape[0] for c in codes_rows])
    codes, spans, zeros, bits = _to(
        dev, np.concatenate(codes_rows), np.concatenate(span_rows),
        np.concatenate(zero_rows), np.concatenate(bits_rows))
    out = kv_dequant_mixed(codes, spans, zeros, bits, group=group,
                           out_dtype=out_dtype)
    results = []
    for i, qt in enumerate(qts):
        n_vals = int(np.prod(qt.shape))
        rows = out[starts[i]:starts[i + 1]]
        results.append(rows.reshape(-1)[:n_vals].reshape(qt.shape))
    return results
