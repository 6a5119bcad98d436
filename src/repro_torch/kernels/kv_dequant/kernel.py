"""KV-chunk dequantization: the CUDA kernel and its plain PyTorch
versions.

The kernel (``csrc/kv_dequant.cu``) replaces both Pallas kernels of
``repro/kernels/kv_dequant/kernel.py``. One launch takes a ``Batch``: the
codes, per-group parameters and zeros of many chunk tensors (entries),
concatenated as whole groups into flat buffers, and an entry table with a
row per entry (first group, value count, destination address,
bit-width, first code). It writes each entry's values straight to its
destination, such as a chunk's slot of the KV cache. ``dequant_batch``
launches it on CUDA tensors; ``kv_dequant`` and ``kv_dequant_mixed`` keep
the Pallas kernels' row-matrix contracts and launch the same kernel (one
entry, or one entry a row). Each launch adds one to ``LAUNCHES``:
"kv_dequant" for the uniform form (the parameters are the steps),
"kv_dequant_mixed" for the mixed form (the parameters are spans, and an
entry's step is span / (2^bits - 1)).

The ``*_plain`` functions compute the same values with torch ops:
``torch.addcmul`` rounds ``code * step + zero`` once, as the kernel's
``__fmaf_rn`` and the Pallas kernels do (``c * s + z`` rounds twice and
is not bit-equal). The CPU path takes the plain versions; the card never
does (``ops.py`` dispatches on the tensor's device).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels import _build

LAUNCHES = {"kv_dequant": 0, "kv_dequant_mixed": 0}

_OUT_DTYPES = (torch.float32, torch.bfloat16)
_MAX_SPAN = 2 ** 31  # codes an entry spans at most (the kernel's offsets)
_COLS = 5            # first group, value count, address, bits, first code


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def supported(group: int, width: int) -> bool:
    """Whether the kernel takes rows of `width` codes in groups of `group`:
    any group that divides the width, as the reference's quantizer and
    Pallas kernels take. Needs no card."""
    return group >= 1 and width >= 1 and width % group == 0


@dataclasses.dataclass
class Batch:
    """One launch's work, all on one device.

    codes: (n_codes,) uint8; params: (n_groups,) float32, the steps, or
    the spans when ``mixed``; zeros: (n_groups,) float32; table: (E, 5)
    int64, a row per entry: its first group, its value count, its
    destination's address, its bit-width and its first code, sorted by
    first group and first code (an entry's groups are the ceil(n_vals /
    group) from its first group, and its codes as many whole groups from
    its first code; ``bits`` is read only when ``mixed``); dests: the E
    contiguous tensors, all float32 or all bfloat16, whose first n_vals
    elements the entries fill (``dst`` is their address); rows: the table
    as the host built it, which the launcher checks without reading the
    device."""
    codes: torch.Tensor
    params: torch.Tensor
    zeros: torch.Tensor
    table: torch.Tensor
    dests: list
    rows: np.ndarray
    group: int
    mixed: bool


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


def dequant_batch_plain(b: Batch) -> None:
    """The kernel's work on a batch, entry by entry: reads the same flat
    buffers and the same table (its device copy) and writes the same
    destinations, whose addresses it checks against the table."""
    for e, (first, n, dst, bits, c0) in enumerate(b.table.tolist()):
        out = b.dests[e]
        if out.data_ptr() != dst:
            raise ValueError(f"entry {e}: the table's address is not its "
                             "destination's")
        ng = -(-n // b.group)
        c = b.codes[c0:c0 + ng * b.group]
        c = c.to(torch.float32).view(ng, b.group)
        step = b.params[first:first + ng]
        if b.mixed:
            step = step / torch.full_like(step, float((1 << bits) - 1))
        x = torch.addcmul(b.zeros[first:first + ng, None], c, step[:, None])
        out.view(-1)[:n] = x.view(-1)[:n]


# ----------------------------------------------------------------------------
# CUDA launchers
# ----------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("kv_dequant")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.kv_dequant_launch.argtypes = [p, p, p, p, i, ll, i, i, i, p]
        lib.kv_dequant_launch.restype = i
        lib.kv_dequant_grid.argtypes = [ll, i, i]
        lib.kv_dequant_grid.restype = i
        _LIB = lib
    return _LIB


def grid_size(n_codes: int, *, mixed: bool, out_dtype) -> int:
    """The CTAs one launch over n_codes codes takes on this card."""
    g = _lib().kv_dequant_grid(n_codes, int(mixed),
                               int(out_dtype == torch.bfloat16))
    if g < 0:
        raise RuntimeError(f"kv_dequant grid query failed: CUDA error {-g}")
    return g


def _launch(codes, params, zeros, table, n_entries, group, mixed,
            out_dtype):
    """One launch on the current stream; counts it and raises on a CUDA
    error."""
    name = "kv_dequant_mixed" if mixed else "kv_dequant"
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = _lib().kv_dequant_launch(
        codes.data_ptr(), params.data_ptr(), zeros.data_ptr(),
        table.data_ptr(), n_entries, codes.numel(), group, int(mixed),
        int(out_dtype == torch.bfloat16), stream)
    LAUNCHES[name] += 1
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _check_batch(b: Batch):
    """Raise unless the kernel can take `b`; returns the output dtype."""
    if b.codes.device.type != "cuda":
        raise ValueError(f"kernel needs CUDA tensors, got {b.codes.device}")
    if b.group <= 0:
        raise ValueError(f"group {b.group} must be positive")
    n_groups = b.params.numel()
    if b.codes.dtype != torch.uint8 or b.codes.dim() != 1:
        raise ValueError("codes must be a flat uint8 tensor")
    for name, t, dt, n in (
            ("params", b.params, torch.float32, n_groups),
            ("zeros", b.zeros, torch.float32, n_groups)):
        if t.dtype != dt or t.numel() != n:
            raise ValueError(f"{name} must hold {n} {dt} values")
        if t.device != b.codes.device or not t.is_contiguous():
            raise ValueError("all inputs must be contiguous on one device")
    if b.codes.data_ptr() % 16:
        raise ValueError("codes must be 16-byte aligned")
    n_entries = len(b.dests)
    if (b.table.dtype != torch.int64
            or tuple(b.table.shape) != (n_entries, _COLS)
            or b.table.device != b.codes.device
            or not b.table.is_contiguous()
            or b.rows.shape != (n_entries, _COLS)):
        raise ValueError(f"the table must be ({n_entries}, {_COLS}) int64, "
                         "contiguous on the codes' device")
    if n_entries >= 2 ** 31:
        raise ValueError("too many entries for one launch")
    out_dtype = b.dests[0].dtype if n_entries else torch.float32
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"destinations must be one of {_OUT_DTYPES}")
    for e, d in enumerate(b.dests):
        if (d.dtype != out_dtype or d.device != b.codes.device
                or not d.is_contiguous()):
            raise ValueError(f"destination {e} must be a contiguous "
                             f"{out_dtype} tensor on {b.codes.device}")
        if d.data_ptr() % 16:
            raise ValueError(f"destination {e} is not 16-byte aligned")
        if d.data_ptr() != b.rows[e, 2] or b.rows[e, 1] > d.numel():
            raise ValueError(f"entry {e} does not fit its destination")
    if not n_entries:
        return out_dtype
    first, n, c0 = b.rows[:, 0], b.rows[:, 1], b.rows[:, 4]
    span = -(-n // b.group)
    if ((n <= 0).any() or first[0] < 0 or c0[0] < 0
            or (span * b.group >= _MAX_SPAN).any()
            or (first[1:] < first[:-1] + span[:-1]).any()
            or first[-1] + span[-1] > n_groups
            or (c0[1:] < c0[:-1] + span[:-1] * b.group).any()
            or c0[-1] + span[-1] * b.group > b.codes.numel()):
        raise ValueError("entries must hold values, stay inside the flat "
                         "buffers and follow each other without overlap")
    if b.mixed and not ((b.rows[:, 3] >= 1) & (b.rows[:, 3] <= 8)).all():
        raise ValueError("mixed bit-widths must lie in [1, 8]")
    order = np.argsort(b.rows[:, 2], kind="stable")
    start = b.rows[order, 2]
    stop = start + n[order] * b.dests[0].element_size()
    if (stop[:-1] > start[1:]).any():
        raise ValueError("destinations overlap")
    return out_dtype


def dequant_batch(b: Batch) -> None:
    """Launch the kernel once over every entry of `b` (CUDA tensors);
    nothing to launch for a batch without entries."""
    out_dtype = _check_batch(b)
    if b.dests:
        _launch(b.codes, b.params, b.zeros, b.table, len(b.dests), b.group,
                b.mixed, out_dtype)


def _check_rows(codes, params, zeros, group, out_dtype, bits=None):
    if codes.device.type != "cuda":
        raise ValueError(f"kernel needs CUDA tensors, got {codes.device}")
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError("codes must be a 2-D uint8 tensor")
    n, width = codes.shape
    if not supported(group, width):
        raise ValueError(f"group {group} must be positive and divide width "
                         f"{width}")
    if n * width >= _MAX_SPAN:
        raise ValueError("codes too large for one launch")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {_OUT_DTYPES}")
    g = width // group
    for name, t in (("scales/spans", params), ("zeros", zeros)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n, g):
            raise ValueError(f"{name} must be float32 of shape {(n, g)}")
    if bits is not None and (bits.dtype != torch.int32
                             or tuple(bits.shape) != (n, 1)):
        raise ValueError(f"bits must be int32 of shape {(n, 1)}")
    for t in (codes, params, zeros) + ((bits,) if bits is not None else ()):
        if t.device != codes.device or not t.is_contiguous():
            raise ValueError("all inputs must be contiguous on one device")
    if codes.data_ptr() % 16:
        raise ValueError("codes must be 16-byte aligned")


def _row_table(out, n_entries, vals, groups, bits=None):
    """Entries of `vals` values (and codes) and `groups` groups each, laid
    end to end in the codes and in `out`, built on the device (no copy
    from the host)."""
    r = torch.arange(n_entries, dtype=torch.int64, device=out.device)
    b = (bits.reshape(-1).to(torch.int64) if bits is not None
         else torch.zeros_like(r))
    return torch.stack([r * groups, torch.full_like(r, vals),
                        r * (vals * out.element_size()) + out.data_ptr(),
                        b, r * vals], 1)


def kv_dequant(codes, scales, zeros, *, group: int,
               out_dtype=torch.bfloat16):
    """Launch the kernel: same contract as ``kv_dequant_plain`` (the
    (n, width) output is one entry)."""
    _check_rows(codes, scales, zeros, group, out_dtype)
    n, width = codes.shape
    out = torch.empty((n, width), dtype=out_dtype, device=codes.device)
    if out.numel():
        table = _row_table(out, 1, n * width, scales.numel())
        _launch(codes, scales, zeros, table, 1, group, False, out_dtype)
    return out


def kv_dequant_mixed(codes, spans, zeros, bits, *, group: int,
                     out_dtype=torch.bfloat16):
    """Launch the kernel in its mixed form: same contract as
    ``kv_dequant_mixed_plain`` (each row is an entry with its bits)."""
    _check_rows(codes, spans, zeros, group, out_dtype, bits=bits)
    n, width = codes.shape
    out = torch.empty((n, width), dtype=out_dtype, device=codes.device)
    if out.numel():
        table = _row_table(out, n, width, width // group, bits)
        _launch(codes, spans, zeros, table, n, group, True, out_dtype)
    return out
