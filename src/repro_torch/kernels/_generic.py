"""The geometry of the generic attention kernels (``csrc/generic_attn.cuh``),
computed without a card.

The C launchers choose the same instance and shared memory from the head
size and the element type; this module states them for the wrappers (the
decode workspace, the split's CTA count) and for the CPU tests, which hold
every head size the port takes to a CTA's shared memory.

- A head size takes the tier of its width, 64, 128 or 256 columns: the
  register arrays' size, with the k-steps a run-time count under it. Past
  256 columns the 256 tier's BIG form splits O's columns into 256-wide
  chunks, one CTA each (``col_chunks``), and computes S chunk by chunk.
- bf16 and fp16 run on the tensor cores: up to 64 query rows and 64-key
  sub-tiles a CTA, rows staged at 16-column multiples plus one 16-byte
  chunk (an odd number of chunks a row). fp32 runs on the CUDA cores: 32
  rows and 32-key sub-tiles, rows at 4-column multiples padded to 4 floats
  past a multiple of 32.
"""
from __future__ import annotations

import torch

CHUNK = 256                 # the widest tier: O's columns a CTA
TIERS = (64, 128, 256)
SEG_ROWS = 8                # kv rows a segment of a sub-tile
MAX_SMEM = 227 * 1024       # shared memory a CTA may hold on an H100


def tier(d: int) -> int:
    """The tier (register arrays' width in columns) of head size d."""
    return next(t for t in TIERS if d <= t) if d <= CHUNK else CHUNK


def col_chunks(d: int) -> int:
    """CTAs that share one row block's keys, each owning 256 of O's
    columns: 1 up to d = 256."""
    return 1 if d <= CHUNK else -(-d // CHUNK)


def _tc(dtype) -> bool:
    return dtype != torch.float32


def cta_rows(dtype, rows: int = 64) -> int:
    """Query rows a CTA takes of `rows` (a q-block's, or the query heads of
    a kv head): on the tensor cores 32 (two m16 tiles) up to 32, else 64
    (four); 32 (8 groups of 4) in fp32."""
    return 64 if _tc(dtype) and rows > 32 else 32


def cta_keys(dtype) -> int:
    """Keys a sub-tile."""
    return 64 if _tc(dtype) else 32


def tc_groups(rows: int) -> int:
    """16-key groups a tensor-core warp takes of each 64-key sub-tile, for
    a CTA of `rows` query rows (at most 64): the 4 warps share one m16
    tile's keys, split two tiles' in halves, or take a tile each."""
    tiles = -(-min(rows, 64) // 16)
    return 1 if tiles == 1 else 2 if tiles == 2 else 4


def width(d: int, dtype) -> int:
    """Columns a staged row holds: d padded with zeros to 16 (tensor
    cores) or 4 (fp32)."""
    unit = 16 if _tc(dtype) else 4
    return -(-d // unit) * unit


def _pitch(cw: int, dtype) -> int:
    """Elements a staged row of cw columns takes in shared memory."""
    return cw + 8 if _tc(dtype) else -(-cw // 32) * 32 + 4


def stages(d: int, dtype, decode: bool = False) -> int:
    """Stages of a CTA's ring: 3 for decode on the tensor cores up to 128
    columns, else 2."""
    return 3 if decode and _tc(dtype) and d <= 128 else 2


def smem_bytes(d: int, dtype, rows: int = 64, decode: bool = False) -> int:
    """Dynamic shared memory of one CTA (``gen::smem_bytes``) at head size
    d for `rows` query rows: the ring of K and V sub-tiles (``stages``) and
    Q, or past 256 columns one Q and one K/V chunk (BIG, whose tensor-core
    instance takes 64 rows); then the segments; at least the tensor-core
    warps' partials merged at the end (a warp's m, l and padded O rows,
    then each row's m and l)."""
    w, keys = width(d, dtype), cta_keys(dtype)
    big = w > CHUNK
    n_rows = cta_rows(dtype, 64 if big else rows)
    cw = CHUNK if big else w
    p = _pitch(cw, dtype)
    ns = 1 if big else stages(d, dtype, decode)
    tiles = (n_rows + keys) * p if big else ns * 2 * keys * p + n_rows * p
    elem = 2 if _tc(dtype) else 4
    nbytes = tiles * elem + ns * keys // SEG_ROWS * 8
    part = (4 * (4 * (32 + 16 * (cw + 1)) + 2 * n_rows) if _tc(dtype)
            else 0)
    return max(nbytes, part)
