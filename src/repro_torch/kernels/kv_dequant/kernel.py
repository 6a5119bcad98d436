"""Fused KV-chunk dequantization: the CUDA kernels and their plain
PyTorch versions.

The kernels (``csrc/kv_dequant.cu``) replace the Pallas kernels of
``repro/kernels/kv_dequant/kernel.py``. ``kv_dequant`` and
``kv_dequant_mixed`` launch them on CUDA tensors; each launch adds one to
``LAUNCHES``. The ``*_plain`` functions compute the same values with
torch ops: ``torch.addcmul`` rounds ``code * step + zero`` once, as the
kernels' ``__fmaf_rn`` and the Pallas kernel do (``c * s + z`` rounds
twice and is not bit-equal). The CPU path takes the plain versions; the
card never does (``ops.py`` dispatches on the tensor's device).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"kv_dequant": 0, "kv_dequant_mixed": 0}

_OUT_DTYPES = (torch.float32, torch.bfloat16)
_VEC = 16            # codes per CUDA thread (one 16-byte load)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------------


def kv_dequant_plain(codes, scales, zeros, *, group: int,
                     out_dtype=torch.bfloat16):
    """codes: (n, width) uint8; scales/zeros: (n, width//group) float32
    -> (n, width) out_dtype, each value ``fma(code, scale, zero)``."""
    n, width = codes.shape
    g = width // group
    c = codes.to(torch.float32).reshape(n, g, group)
    x = torch.addcmul(zeros[..., None], c, scales[..., None])
    return x.reshape(n, width).to(out_dtype)


def kv_dequant_mixed_plain(codes, spans, zeros, bits, *, group: int,
                           out_dtype=torch.bfloat16):
    """Mixed bit-widths: bits (n, 1) int32; a row's step is the IEEE fp32
    quotient spans / (2^bits - 1)."""
    n, width = codes.shape
    g = width // group
    c = codes.to(torch.float32).reshape(n, g, group)
    q = ((1 << bits.to(torch.int32)) - 1).to(torch.float32)
    step = spans / q
    x = torch.addcmul(zeros[..., None], c, step[..., None])
    return x.reshape(n, width).to(out_dtype)


# ----------------------------------------------------------------------------
# CUDA launchers
# ----------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("kv_dequant")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.kv_dequant_launch.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.kv_dequant_launch.restype = i
        lib.kv_dequant_mixed_launch.argtypes = [p, p, p, p, p, i, i, i, i,
                                                p]
        lib.kv_dequant_mixed_launch.restype = i
        _LIB = lib
    return _LIB


def _check(codes, params, zeros, group, out_dtype, bits=None):
    if codes.device.type != "cuda":
        raise ValueError(f"kernel needs CUDA tensors, got {codes.device}")
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError("codes must be a 2-D uint8 tensor")
    n, width = codes.shape
    if group <= 0 or group % _VEC or width % group:
        raise ValueError(f"group {group} must divide width {width} and be "
                         f"a multiple of {_VEC}")
    if n >= 2 ** 31 or width >= 2 ** 31:
        raise ValueError("codes too large for the kernel's int sizes")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {_OUT_DTYPES}")
    g = width // group
    for name, t in (("scales/spans", params), ("zeros", zeros)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n, g):
            raise ValueError(f"{name} must be float32 of shape {(n, g)}")
    tensors = [codes, params, zeros]
    if bits is not None:
        if bits.dtype != torch.int32 or tuple(bits.shape) != (n, 1):
            raise ValueError(f"bits must be int32 of shape {(n, 1)}")
        tensors.append(bits)
    for t in tensors:
        if t.device != codes.device or not t.is_contiguous():
            raise ValueError("all inputs must be contiguous on one device")
    if codes.data_ptr() % 16:
        raise ValueError("codes must be 16-byte aligned")


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def kv_dequant(codes, scales, zeros, *, group: int,
               out_dtype=torch.bfloat16):
    """Launch the CUDA kernel: same contract as ``kv_dequant_plain``."""
    _check(codes, scales, zeros, group, out_dtype)
    lib = _lib()
    n, width = codes.shape
    out = torch.empty((n, width), dtype=out_dtype, device=codes.device)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = lib.kv_dequant_launch(
        codes.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
        out.data_ptr(), n, width, group, int(out_dtype == torch.bfloat16),
        stream)
    LAUNCHES["kv_dequant"] += 1
    _raise_on(err, "kv_dequant")
    return out


def kv_dequant_mixed(codes, spans, zeros, bits, *, group: int,
                     out_dtype=torch.bfloat16):
    """Launch the mixed-bitwidth CUDA kernel: same contract as
    ``kv_dequant_mixed_plain``."""
    _check(codes, spans, zeros, group, out_dtype, bits=bits)
    lib = _lib()
    n, width = codes.shape
    out = torch.empty((n, width), dtype=out_dtype, device=codes.device)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = lib.kv_dequant_mixed_launch(
        codes.data_ptr(), spans.data_ptr(), zeros.data_ptr(),
        bits.data_ptr(), out.data_ptr(), n, width, group,
        int(out_dtype == torch.bfloat16), stream)
    LAUNCHES["kv_dequant_mixed"] += 1
    _raise_on(err, "kv_dequant_mixed")
    return out
