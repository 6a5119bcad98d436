"""Wrapper: QuantizedTensor (wire format) -> KV values on a device, via
the dequantization kernel on CUDA and its plain version on the CPU.

``stage`` lays a list of chunk tensors out as one ``kernel.Batch``: their
codes, parameters and zeros concatenated as whole groups, and an entry
table whose rows point at the caller's destination tensors. Everything
is written into one host buffer, pinned when the device is the card,
and reaches the device in one non-blocking copy. PyTorch's caching host
allocator keeps the pinned block for the next batch of its size, and
holds it back until the copy out of it has completed. ``dequantize_into``
stages and launches; ``dequantize_chunk`` and ``dequantize_chunks_mixed``
keep the reference's per-chunk contracts on top of it.
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


def dequant_batch(b: K.Batch) -> None:
    """Same dispatch for a batch: one kernel launch on the card, the plain
    version on the CPU."""
    if b.codes.device.type == "cuda":
        return K.dequant_batch(b)
    if b.codes.device.type == "cpu":
        return K.dequant_batch_plain(b)
    raise ValueError(f"no kv_dequant for device {b.codes.device}")


def _spans_of(qt: QuantizedTensor) -> np.ndarray:
    if qt.spans is not None:
        return qt.spans
    # pre-spans tensors: reconstruct (scales were span / (2^bits - 1))
    return (qt.scales * np.float32((1 << qt.bits) - 1)).astype(np.float32)


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def stage(qts: list, dests: list, *, mixed: bool) -> K.Batch:
    """One batch whose entry e writes qts[e]'s values into dests[e] (a
    contiguous tensor on the device, at least that many elements). The
    uniform form carries the steps (``scales``); the mixed form the spans
    and each entry's bit-width. Chunks without values are left out."""
    if len(qts) != len(dests) or not qts:
        raise ValueError("one destination per chunk, and at least one")
    group = qts[0].group
    if any(q.group != group for q in qts):
        raise ValueError("heterogeneous group size")
    dev = dests[0].device
    keep = [e for e, q in enumerate(qts) if int(np.prod(q.shape))]
    qts, dests = [qts[e] for e in keep], [dests[e] for e in keep]
    n_vals = np.array([int(np.prod(q.shape)) for q in qts], np.int64)
    n_grp = -(-n_vals // group)
    first = np.cumsum(n_grp) - n_grp
    n_groups = int(n_grp.sum())
    o_par = _up16(n_groups * group)
    o_zero = o_par + _up16(4 * n_groups)
    o_tab = o_zero + _up16(4 * n_groups)
    host = torch.empty(o_tab + 32 * len(qts), dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    h = host.numpy()
    codes = h[:n_groups * group]
    params = h[o_par:o_par + 4 * n_groups].view(np.float32)
    zeros = h[o_zero:o_zero + 4 * n_groups].view(np.float32)
    rows = h[o_tab:].view(np.int64).reshape(-1, 4)
    for q, a, g, n in zip(qts, first, n_grp, n_vals):
        codes[a * group:a * group + n] = q.codes
        codes[a * group + n:(a + g) * group] = 0
        params[a:a + g] = (_spans_of(q) if mixed else q.scales)[:g]
        zeros[a:a + g] = q.zeros[:g]
    rows[:, 0], rows[:, 1] = first, n_vals
    rows[:, 2] = [d.data_ptr() for d in dests]
    rows[:, 3] = [q.bits for q in qts] if mixed else 0
    rows = rows.copy()            # the host buffer goes back to its pool
    buf = host.to(dev, non_blocking=True)
    return K.Batch(
        codes=buf[:n_groups * group],
        params=buf[o_par:o_par + 4 * n_groups].view(torch.float32),
        zeros=buf[o_zero:o_zero + 4 * n_groups].view(torch.float32),
        table=buf[o_tab:].view(torch.int64).view(-1, 4), dests=dests,
        rows=rows, group=group, mixed=mixed)


def dequantize_into(qts: list, dests: list, *, mixed: bool) -> None:
    """Dequantize chunk tensors straight into `dests` (see ``stage``) in
    one kernel launch on the card."""
    dequant_batch(stage(qts, dests, mixed=mixed))


def dequantize_chunk(qt: QuantizedTensor, *, out_dtype=torch.bfloat16,
                     device=None) -> torch.Tensor:
    """Dequantize a streamed KV chunk on `device` (default: the card).
    Returns a qt.shape tensor."""
    out = torch.empty(qt.shape, dtype=out_dtype, device=resolve(device))
    dequantize_into([qt], [out], mixed=False)
    return out


def dequantize_chunks_mixed(qts: list, *, out_dtype=torch.bfloat16,
                            device=None) -> list:
    """Dequantize many streamed KV chunks of heterogeneous bit-widths in
    ONE kernel launch. All chunks must share the quantization group size;
    each entry carries its chunk's bit-width. Returns one qt.shape tensor
    per input, each exactly equal (in fp32) to its `dequantize_chunk`."""
    assert qts, "empty chunk list"
    dev = resolve(device)
    outs = [torch.empty(q.shape, dtype=out_dtype, device=dev) for q in qts]
    dequantize_into(qts, outs, mixed=True)
    return outs
