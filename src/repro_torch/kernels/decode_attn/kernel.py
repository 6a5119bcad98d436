"""GQA flash-decode: the CUDA kernel and its plain PyTorch version.

The kernel (``csrc/decode_attn.cu``) replaces the Pallas kernel of
``repro/kernels/decode_attn/kernel.py``. ``decode_attention`` launches it
on CUDA tensors: one launch a call (``kv_len`` 0 included, which writes
zeros), and each launch adds one to ``LAUNCHES``. The kernel splits the
cache its own way, by ``split_plan`` from the card's SM count, into one
thread block cluster a (batch, kv head) that combines its splits in the
same launch; ``kv_block`` only sets the plain version's blocks, since the
split changes nothing but the order of sums.
``decode_attention_plain`` computes the same function with torch ops:
per kv block of ``kv_block`` keys, the block's max, p rounded to v's
dtype before the PV product, and the blocks' fp32 partials combined at
the end. The Pallas kernel carries one running softmax over the blocks
instead; the two agree to rounding. The CPU path takes the plain version
(``ops.py``); the card never does.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

LAUNCHES = {"decode_attention": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (32, 64, 128, 256)
_GROUPS = (1, 2, 4, 8, 16)    # query heads per kv head (a template)
_SPLIT_ROWS = 64       # a split holds a multiple of this many key rows
_MIN_SPLIT = 256       # keys a split at least, to amortise its combine
_MAX_SPLITS = 16       # a cluster's CTAs (csrc/decode_attn.cu kMaxCluster)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------------------------
# Plain version
# ----------------------------------------------------------------------------


def decode_attention_plain(q, k, v, kv_len: int, *, kv_block: int = 256,
                           scale: float | None = None):
    """q: (b, hq, d); k/v: (b, skv, hkv, d); the first kv_len positions
    are valid -> (b, hq, d) in q's dtype (zeros when kv_len is 0)."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    if not 0 <= kv_len <= k.shape[1]:
        raise ValueError(f"kv_len {kv_len} outside [0, {k.shape[1]}]")
    n_blk = -(-kv_len // kv_block)
    if n_blk == 0:
        return torch.zeros_like(q)
    pad = n_blk * kv_block - kv_len
    kk = F.pad(k[:, :kv_len].float(), (0, 0, 0, 0, 0, pad))
    vv = F.pad(v[:, :kv_len].float(), (0, 0, 0, 0, 0, pad))
    kk = kk.reshape(b, n_blk, kv_block, hkv, d)
    vv = vv.reshape(b, n_blk, kv_block, hkv, d)
    qg = q.float().reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bnkhd->bhgnk", qg, kk) * scale
    valid = (torch.arange(n_blk * kv_block, device=q.device)
             < kv_len).reshape(n_blk, kv_block)
    s = s.masked_fill(~valid, -torch.inf)
    m = s.amax(-1)                                   # (b, hkv, g, n_blk)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bhgnk,bnkhd->bhgnd", p.to(v.dtype).float(), vv)
    w = torch.exp(m - m.amax(-1, keepdim=True))
    out = (acc * w[..., None]).sum(-2) / (l * w).sum(-1)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)


# ----------------------------------------------------------------------------
# CUDA launcher
# ----------------------------------------------------------------------------


def split_plan(b: int, hkv: int, kv_len: int, n_sm: int) -> tuple[int, int]:
    """(keys per split, number of splits) for the kernel: at most
    ``_MAX_SPLITS`` splits of a (batch, kv head), each a whole multiple of
    ``_SPLIT_ROWS`` keys and about ``_MIN_SPLIT`` keys or more, as many as
    bring ``b * hkv * n_split`` to two CTAs an SM where kv_len and the
    cluster allow. The splits tile ``[0, kv_len)``, none empty; kv_len 0
    gives one empty split."""
    if kv_len <= 0:
        return _SPLIT_ROWS, 1
    rows = -(-kv_len // _SPLIT_ROWS)           # 64-key rows of the cache
    want = min(_MAX_SPLITS, -(-kv_len // _MIN_SPLIT),
               -(-2 * n_sm // (b * hkv)))
    chunk = -(-rows // want) * _SPLIT_ROWS
    return chunk, -(-kv_len // chunk)


_SM_COUNT: dict[int, int] = {}


def _sm_count(dev) -> int:
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _SM_COUNT:
        props = torch.cuda.get_device_properties(i)
        _SM_COUNT[i] = props.multi_processor_count
    return _SM_COUNT[i]


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("decode_attn")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_launch.argtypes = [
            p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        lib.decode_attention_launch.restype = i
        _LIB = lib
    return _LIB


def _check(q, k, v, kv_len):
    if q.device.type != "cuda":
        raise ValueError(f"kernel needs CUDA tensors, got {q.device}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be (b, hq, d) and k, v (b, skv, hkv, d)")
    b, hq, d = q.shape
    kb, skv, hkv, dk = k.shape
    if kb != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         "not match")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head size {d} not in {_HEAD_DIMS}")
    if hq // hkv not in _GROUPS:
        raise ValueError(f"{hq // hkv} query heads per kv head, not one of "
                         f"{_GROUPS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of {_DTYPES}")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("all inputs must be contiguous on one device")
        if t.data_ptr() % 16:
            raise ValueError("q, k, v must be 16-byte aligned")
    if not 0 <= kv_len <= skv:
        raise ValueError(f"kv_len {kv_len} outside [0, {skv}]")
    if b >= 65536 or hkv >= 65536:
        raise ValueError("inputs too large for the kernel's grid")


def decode_attention(q, k, v, kv_len: int, *, kv_block: int = 256,
                     scale: float | None = None):
    """Launch the CUDA kernel: same contract as
    ``decode_attention_plain``. ``kv_block`` must be positive; the
    kernel's split is ``split_plan``'s, which changes only the order of
    sums."""
    kv_len = int(kv_len)
    if kv_block <= 0:
        raise ValueError(f"kv_block {kv_block} must be positive")
    _check(q, k, v, kv_len)
    b, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    chunk, n_split = split_plan(b, hkv, kv_len, _sm_count(q.device))
    lib = _lib()
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, skv, hq,
        hkv, d, kv_len, chunk, n_split, float(scale),
        int(q.dtype == torch.bfloat16), stream)
    LAUNCHES["decode_attention"] += 1
    if err:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")
    return out
