"""Huffman decode of streamed KV chunk tensors: the CUDA kernel's launcher
and the host-side layout it reads.

The kernel (``csrc/huffman_decode.cu``) replaces no Pallas kernel: the
reference decodes on the host (``compression.huffman.decode``, copied
verbatim into the port, which the CPU path keeps). One launch decodes the
``EncodedChunk``s of one streamed chunk, its K and V tensors, a block a
tensor and a thread a stream, to the same codes in the same flat order.

``layout`` and ``pack`` lay the tensors out in one host buffer: an int64
row per tensor (``_COLS`` columns), then per tensor its code lengths, its
stream rows zero-padded to whole ``LINE``-byte lines and one line more,
and its (segment start, symbol count) pair a stream, every section on a
16-byte boundary.
``decode_chunks`` packs into a pinned buffer, copies it to the card in one
non-blocking copy, launches once, copies the codes back and waits for
them. Each launch adds one to ``LAUNCHES["huffman_decode"]``.

``packed_table`` computes on the host the kernel's shared-memory table,
so the CPU tests hold it and the buffer's layout against the reference's
decoder without a card.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.compression.huffman import MAX_LEN
from repro_torch.kernels import _build

LAUNCHES = {"huffman_decode": 0}

MAX_ALPHABET = 256   # uint8 codes: one symbol a thread of the block
# columns of a tensor's row: first stream row, row stride, stream count,
# code lengths, alphabet size, (segment start, count) pairs, output offset
STREAMS, STRIDE, N_STREAMS, LENS, N_ALPHA, SEGS, OUT = range(7)
_COLS = 7
_MAX_SYMBOLS = 2 ** 31    # a tensor's symbols (the kernel's int counts)
LINE = 128   # bytes of a stream row the kernel fetches at a time


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _up(n: int, to: int = 16) -> int:
    return -(-n // to) * to


def segments(n_per_stream) -> np.ndarray:
    """(S, 2) int64: each stream's first output position (the prefix sum
    of the symbol counts before it) and its symbol count."""
    n = np.asarray(n_per_stream, np.int64)
    return np.stack([np.cumsum(n) - n, n], 1)


def packed_table(lengths) -> np.ndarray:
    """The kernel's shared-memory table from the code lengths alone:
    (2^MAX_LEN,) uint16, symbol | length << 8 for the code the next
    MAX_LEN bits start with, 0 past the last code. Canonical codes,
    left-justified, are contiguous in (length, symbol) order, so each
    symbol's first entry is the sum of the spans before it."""
    lens = np.asarray(lengths, np.int64)
    order = sorted((int(l), s) for s, l in enumerate(lens) if l > 0)
    table = np.zeros(1 << MAX_LEN, np.uint16)
    first = 0
    for l, s in order:
        span = 1 << (MAX_LEN - l)
        table[first:first + span] = s | (l << 8)
        first += span
    return table


def check(enc) -> None:
    """Raise ValueError unless the kernel can take `enc` (an
    ``EncodedChunk``). Needs no card."""
    streams = enc.streams
    if not isinstance(streams, np.ndarray) or streams.dtype != np.uint8 \
            or streams.ndim != 2 or streams.shape[0] < 1:
        raise ValueError("streams must be a 2-D uint8 array of at least "
                         "one stream")
    n_per = np.asarray(enc.n_per_stream)
    if n_per.shape != (streams.shape[0],) or (n_per < 0).any():
        raise ValueError("one non-negative symbol count a stream")
    if int(n_per.sum()) != enc.n_total or enc.n_total >= _MAX_SYMBOLS:
        raise ValueError(f"the stream counts must sum to the tensor's "
                         f"{enc.n_total} symbols, under {_MAX_SYMBOLS}")
    lens = np.asarray(enc.code.lengths)
    if lens.ndim != 1 or not 1 <= len(lens) <= MAX_ALPHABET:
        raise ValueError(f"the kernel takes alphabets of 1 to "
                         f"{MAX_ALPHABET} symbols, got {len(lens)}")
    if ((lens < 0) | (lens > MAX_LEN)).any():
        raise ValueError(f"code lengths must lie in [0, {MAX_LEN}]")
    spans = np.where(lens > 0, 1 << (MAX_LEN - np.clip(lens, 1, MAX_LEN)),
                     0)
    if int(spans.sum()) > 1 << MAX_LEN:
        raise ValueError("the code lengths break Kraft's inequality: no "
                         "prefix code has them")


@dataclasses.dataclass
class Layout:
    """Where `pack` puts each tensor: ``rows`` (T, _COLS) int64 (the
    buffer's head), ``nbytes`` the buffer's size, ``sizes`` each tensor's
    symbols and ``out_bytes`` the codes' buffer (each tensor's codes at
    ``rows[:, OUT]``)."""
    rows: np.ndarray
    nbytes: int
    sizes: list
    out_bytes: int


def layout(encs) -> Layout:
    """The buffer's layout for `encs`, each checked first."""
    for e in encs:
        check(e)
    rows = np.zeros((len(encs), _COLS), np.int64)
    at = _up(8 * _COLS * len(encs))
    out = 0
    for t, e in enumerate(encs):
        s, nbytes = e.streams.shape
        stride, n_alpha = _up(nbytes, LINE) + LINE, len(e.code.lengths)
        lens_at = at
        streams_at = lens_at + _up(n_alpha)
        segs_at = streams_at + s * stride
        at = segs_at + 16 * s
        rows[t] = (streams_at, stride, s, lens_at, n_alpha, segs_at, out)
        out += _up(e.n_total)
    return Layout(rows=rows, nbytes=at, sizes=[e.n_total for e in encs],
                  out_bytes=out)


def pack(encs, lay: Layout, h: np.ndarray) -> None:
    """Write `encs` into `h` (uint8, ``lay.nbytes``) as `lay` places them;
    stream rows are zero past their bytes."""
    h[:8 * lay.rows.size].view(np.int64)[:] = lay.rows.reshape(-1)
    for e, row in zip(encs, lay.rows):
        s, nbytes = e.streams.shape
        a = int(row[LENS])
        h[a:a + row[N_ALPHA]] = e.code.lengths
        a = int(row[STREAMS])
        rows = h[a:a + s * row[STRIDE]].reshape(s, row[STRIDE])
        rows[:, :nbytes] = e.streams
        rows[:, nbytes:] = 0
        a = int(row[SEGS])
        h[a:a + 16 * s].view(np.int64)[:] = \
            segments(e.n_per_stream).reshape(-1)


# ----------------------------------------------------------------------------
# CUDA launcher
# ----------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("huffman_decode")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.huffman_decode_launch.argtypes = [p, p, i, p]
        lib.huffman_decode_launch.restype = i
        _LIB = lib
    return _LIB


def launch(buf: torch.Tensor, out: torch.Tensor, n_tensors: int) -> None:
    """One launch on the current stream over a packed buffer on the card;
    counts it and raises on a CUDA error."""
    if buf.device.type != "cuda" or out.device != buf.device:
        raise ValueError("the packed buffer and the output must be on one "
                         "CUDA device")
    for t in (buf, out):
        if t.dtype != torch.uint8 or t.dim() != 1 or t.data_ptr() % 16:
            raise ValueError("buffers must be flat, 16-byte aligned uint8")
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    err = _lib().huffman_decode_launch(buf.data_ptr(), out.data_ptr(),
                                       n_tensors, stream)
    LAUNCHES["huffman_decode"] += 1
    if err:
        raise RuntimeError(f"huffman_decode launch failed: CUDA error {err}")


def decode_chunks(encs, device) -> list:
    """Decode `encs` on the card in one launch: the packed bytes go over
    in one non-blocking copy from pinned memory, the codes come back in
    one. Returns each tensor's codes (uint8) in the reference's order."""
    lay = layout(encs)
    if not lay.out_bytes:
        return [np.zeros(0, np.uint8) for _ in encs]
    host = torch.empty(lay.nbytes, dtype=torch.uint8, pin_memory=True)
    pack(encs, lay, host.numpy())
    buf = host.to(device, non_blocking=True)
    out = torch.empty(lay.out_bytes, dtype=torch.uint8, device=device)
    launch(buf, out, len(encs))
    back = torch.empty(lay.out_bytes, dtype=torch.uint8, pin_memory=True)
    back.copy_(out, non_blocking=True)
    torch.cuda.current_stream(device).synchronize()
    h = back.numpy()
    return [h[o:o + n] for o, n in zip(lay.rows[:, OUT].tolist(), lay.sizes)]
