"""Per-group uniform quantization for streamed KV chunks (paper §V: 5-bit
uniform + Huffman; CacheGen-style layer-wise bit allocation supported).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class QuantizedTensor:
    codes: np.ndarray      # uint8 symbols in [0, 2^bits)
    scales: np.ndarray     # (groups,) float32 step = span / (2^bits - 1)
    zeros: np.ndarray      # (groups,) float32
    bits: int
    group: int
    shape: tuple
    dtype: str = "float32"
    # per-group value range hi - lo (clamped). Bit-width independent, so
    # the mixed-bitwidth dequant path can re-derive any width's step as
    # spans / (2^bits - 1) from one shared parameter plane. None on
    # tensors quantized before this field existed.
    spans: np.ndarray = None

    @property
    def n_symbols(self) -> int:
        return 1 << self.bits

    def header_bytes(self) -> int:
        # scales+zeros in fp16 on the wire + small fixed header
        return 2 * 2 * self.scales.size + 16


def quantize(x: np.ndarray, bits: int, group: int) -> QuantizedTensor:
    """Uniform asymmetric per-group quantization. x flattened to groups."""
    shape = x.shape
    flat = np.asarray(x, np.float32).reshape(-1)
    pad = (-len(flat)) % group
    if pad:
        # edge-pad so the tail group's lo/hi come from its real values
        # only (a repeated member never widens min/max); zero-padding
        # biased the tail group's affine params toward 0.0 whenever
        # x.size % group != 0
        flat = np.pad(flat, (0, pad), mode="edge") if len(flat) else \
            np.zeros(pad, np.float32)
    g = flat.reshape(-1, group)
    lo = g.min(axis=1)
    hi = g.max(axis=1)
    span = np.maximum(hi - lo, 1e-8)
    q = (1 << bits) - 1
    scales = span / q
    codes = np.clip(np.round((g - lo[:, None]) / scales[:, None]),
                    0, q).astype(np.uint8)
    return QuantizedTensor(codes=codes.reshape(-1)[:int(np.prod(shape))],
                           scales=scales.astype(np.float32),
                           zeros=lo.astype(np.float32),
                           bits=bits, group=group, shape=tuple(shape),
                           spans=span.astype(np.float32))


def dequantize(qt: QuantizedTensor) -> np.ndarray:
    flat = qt.codes.astype(np.float32)
    pad = (-len(flat)) % qt.group
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    g = flat.reshape(-1, qt.group)
    x = g * qt.scales[:, None] + qt.zeros[:, None]
    return x.reshape(-1)[:int(np.prod(qt.shape))].reshape(qt.shape)


def quant_error(x: np.ndarray, bits: int, group: int) -> float:
    qt = quantize(x, bits, group)
    xr = dequantize(qt)
    denom = float(np.sqrt(np.mean(np.square(x))) + 1e-12)
    return float(np.sqrt(np.mean(np.square(xr - x)))) / denom


# CacheGen-style bitrate ladder for adaptive streaming baselines.
BITRATE_LEVELS = (8, 6, 5, 4, 3)


def downgrade_ladder(bits: int) -> tuple[int, ...]:
    """Ladder levels coarser than `bits`, finest first — the quality-
    shedding walk SLO admission takes when a request's predicted TTFT
    misses its deadline (``repro.serving.slo``): fewer bits means fewer
    streamed bytes at a fidelity cost given by
    ``repro.core.baselines.QUALITY_OF_BITS``."""
    return tuple(b for b in BITRATE_LEVELS if b < bits)


def snap_to_ladder(bits: int) -> int:
    """Nearest supported ``BITRATE_LEVELS`` width (ties resolve to the
    finer level). Every consumer keyed on bit-width — the
    ``baselines.QUALITY_OF_BITS`` fidelity map, the memory server's
    3-bit floor, the SLO ladder walk — is total over ladder widths, so
    allocations must land on them."""
    return min(BITRATE_LEVELS, key=lambda b: (abs(b - bits), -b))


def layerwise_bits(level: int, layer: int, num_layers: int,
                   is_key: bool) -> int:
    """Layer-wise sensitivity allocation: keys and shallow layers get more
    bits (CacheGen observation). level indexes BITRATE_LEVELS. The raw
    base + bonus - penalty arithmetic can land off the ladder (7 from
    level 1 + key bonus; 2 from the deep-layer penalty at the floor), so
    the result is snapped to the nearest supported width."""
    base = BITRATE_LEVELS[level]
    bonus = 1 if (is_key and base < 8) else 0
    penalty = 1 if (layer > (2 * num_layers) // 3 and base > 3) else 0
    return snap_to_ladder(base + bonus - penalty)
