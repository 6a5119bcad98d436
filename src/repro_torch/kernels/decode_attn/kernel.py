"""GQA flash-decode: the CUDA kernel and its plain PyTorch version.

The kernels (``csrc/decode_attn.cu``) replace the Pallas kernel of
``repro/kernels/decode_attn/kernel.py``. ``decode_attention`` launches one
of them on CUDA tensors, one launch a call (``kv_len`` 0 included, which
writes zeros), chosen by shape before the launch: the fast kernels where
``_fast`` holds (head sizes ``_HEAD_DIMS``, 1 to ``_MAX_GROUP`` query
heads a kv head: every attention-bearing config of
``repro_torch.configs``), bf16 and fp16 on the tensor cores and fp32 on
the CUDA cores, each launch adding one to
``LAUNCHES["decode_attention"]``; the generic kernel (any head size up
to ``_GENERIC_MAX_D``, any group, fp32, bf16 or fp16: a CTA takes the
query heads of a kv head as the rows of its tiles, on the tensor cores in
bf16 and fp16, the CUDA cores in fp32) for the rest, adding one to
``LAUNCHES["decode_attention_generic"]``. Both split the cache their own
way from the card's SM count. The fast kernels' ``split_plan`` makes one
thread block cluster a (batch, kv head) that combines its splits in the
same launch; the generic kernel's ``split_plan_generic`` splits until the
launch has a CTA an SM at least, and its splits' partials go to a
workspace (``workspace_floats``) that a second kernel of the same call
combines. ``kv_block`` only sets the plain version's blocks, since the
split changes nothing but the order of sums.

Both take an optional second key segment ``k2, v2, kv_len2`` (the serving
path's decode tail beside its read-only context, same heads and dtype):
the query attends over the first ``kv_len`` keys of k/v followed by the
first ``kv_len2`` of k2/v2, one range that the split tiles as one (a split
may straddle the two; each key is read from the segment it lies in), so
the merge of context and tail is the kernels' own combine, in the same
single launch.
``decode_attention_plain`` computes the same function with torch ops:
per kv block of ``kv_block`` keys, the block's max, p rounded to v's
dtype before the PV product, and the blocks' fp32 partials combined at
the end. The Pallas kernel carries one running softmax over the blocks
instead; the two agree to rounding. The CPU path takes the plain version
(``ops.py``); the card never does. ``supported`` states, without a card,
which head shapes the port takes on the card: what the reference's
contract takes (hq a multiple of hkv), up to the generic kernel's head
size limit, in fp32, bf16 and fp16.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, _generic

LAUNCHES = {"decode_attention": 0, "decode_attention_generic": 0}

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_DTYPE_CODE = {dt: i for i, dt in enumerate(_DTYPES)}    # the C code's
_HEAD_DIMS = (32, 64, 80, 128, 256)   # the fast kernels' head sizes
_MAX_GROUP = 16        # the fast kernels' query heads per kv head, 1 .. this
_MAX_GRID_YZ = 65535   # the fast kernels' kv heads (gridDim.y), batch (z)
# the generic kernel's head sizes: 1 to this (past 256, 8 CTAs a split,
# each owning 256 of O's columns)
_GENERIC_MAX_D = 2048
_SPLIT_ROWS = 64       # a split holds a multiple of this many key rows
_MIN_SPLIT = 256       # keys a split at least, to amortise its combine
_MAX_SPLITS = 16       # a cluster's CTAs (csrc/decode_attn.cu kMaxCluster)
_GEN_MIN_SPLIT = 128   # keys a generic split at least


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------------------------
# Plain version
# ----------------------------------------------------------------------------


def decode_attention_plain(q, k, v, kv_len: int, *, k2=None, v2=None,
                           kv_len2: int = 0, kv_block: int = 256,
                           scale: float | None = None):
    """q: (b, hq, d); k/v: (b, skv, hkv, d); the first kv_len positions
    are valid, then (with k2/v2, (b, skv2, hkv, d)) the first kv_len2 of
    k2/v2 -> (b, hq, d) in q's dtype (zeros when no key is valid)."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    if not 0 <= kv_len <= k.shape[1]:
        raise ValueError(f"kv_len {kv_len} outside [0, {k.shape[1]}]")
    if k2 is not None:
        if not 0 <= kv_len2 <= k2.shape[1]:
            raise ValueError(f"kv_len2 {kv_len2} outside [0, "
                             f"{k2.shape[1]}]")
        k = torch.cat([k[:, :kv_len], k2[:, :kv_len2]], 1)
        v = torch.cat([v[:, :kv_len], v2[:, :kv_len2]], 1)
        kv_len += kv_len2
    elif kv_len2:
        raise ValueError("kv_len2 without a second segment k2, v2")
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


def split_plan_generic(items: int, kv_len: int,
                       n_sm: int) -> tuple[int, int]:
    """(keys per split, number of splits) for the generic kernel over
    ``items`` CTAs a split (batch x kv head x head chunks of
    ``_generic.cta_rows``): whole multiples of ``_SPLIT_ROWS`` keys, about
    ``_GEN_MIN_SPLIT`` or more, as many as bring the launch to two CTAs an
    SM where kv_len allows, so that a few (batch, kv head) pairs still
    fill the card. The splits tile ``[0, kv_len)``, none empty; kv_len 0
    gives one empty split."""
    if kv_len <= 0:
        return _SPLIT_ROWS, 1
    rows = -(-kv_len // _SPLIT_ROWS)
    want = max(1, min(-(-kv_len // _GEN_MIN_SPLIT), -(-2 * n_sm // items)))
    chunk = -(-rows // want) * _SPLIT_ROWS
    return chunk, -(-kv_len // chunk)


def head_chunks(g: int, dtype) -> int:
    """CTAs a split takes for g query heads a kv head (their rows)."""
    return -(-g // _generic.cta_rows(dtype, g))


def workspace_floats(b: int, hq: int, d: int, n_split: int) -> int:
    """fp32 values of the generic kernel's workspace: (m, l) and the
    unnormalised output of every query head and split; none for one
    split, which writes the output itself."""
    return 0 if n_split <= 1 else b * hq * n_split * (d + 2)


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
        # q, k, v, k2, v2, out; b, skv, skv2, hq, hkv, d, kv_len,
        # kv_len2, chunk, n_split; scale, dtype, stream
        lib.decode_attention_launch.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, ctypes.c_float,
            i, p]
        lib.decode_attention_launch.restype = i
        # the generic kernel also takes its workspace, after out
        lib.decode_attention_generic_launch.argtypes = [
            p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i,
            ctypes.c_float, i, p]
        lib.decode_attention_generic_launch.restype = i
        _LIB = lib
    return _LIB


def supported(hq: int, hkv: int, d: int, dtype) -> bool:
    """Whether the port takes hq query heads over hkv kv heads of head
    size d in ``dtype`` on the card: hq a positive multiple of hkv (the
    reference reshapes q to (b, hkv, g, d)), d from 1 to
    ``_GENERIC_MAX_D``, fp32, bf16 or fp16. Needs no card."""
    return (hkv >= 1 and hq >= hkv and hq % hkv == 0
            and 1 <= d <= _GENERIC_MAX_D and dtype in _DTYPES)


def _fast(b: int, hq: int, hkv: int, d: int, dtype) -> bool:
    """The shape test that picks the kernel before the launch: the fast
    kernels where d is in ``_HEAD_DIMS``, the group 1 to ``_MAX_GROUP``
    and b and hkv fit their grid."""
    return (supported(hq, hkv, d, dtype) and d in _HEAD_DIMS
            and hq // hkv <= _MAX_GROUP and b <= _MAX_GRID_YZ
            and hkv <= _MAX_GRID_YZ)


def _check(q, k, v, kv_len, k2, v2, kv_len2):
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be (b, hq, d) and k, v (b, skv, hkv, d)")
    if (k2 is None) != (v2 is None):
        raise ValueError("a second segment takes both k2 and v2")
    if k2 is None and kv_len2:
        raise ValueError("kv_len2 without a second segment k2, v2")
    if k2 is not None and (k2.dim() != 4 or k2.shape != v2.shape
                           or k2.shape[0] != k.shape[0]
                           or k2.shape[2:] != k.shape[2:]):
        raise ValueError(f"k2, v2 {tuple(k2.shape)} must be (b, skv2, hkv, "
                         f"d) of k's {tuple(k.shape)}")
    b, hq, d = q.shape
    kb, skv, hkv, dk = k.shape
    if kb != b or dk != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         "not match")
    if hkv < 1 or hq < hkv or hq % hkv:
        raise ValueError(f"{hq} query heads over {hkv} kv heads: hq must be "
                         "a positive multiple of hkv")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype}: the kernels take {_DTYPES}")
    if not 1 <= d <= _GENERIC_MAX_D:
        raise ValueError(f"head size {d}: the kernels take 1 to "
                         f"{_GENERIC_MAX_D}, the generic kernel's limit")
    segs = (k, v) if k2 is None else (k, v, k2, v2)
    if any(t.dtype != q.dtype for t in segs):
        raise ValueError(f"q, k, v must share one dtype of {_DTYPES}")
    if not 0 <= kv_len <= skv:
        raise ValueError(f"kv_len {kv_len} outside [0, {skv}]")
    if k2 is not None and not 0 <= kv_len2 <= k2.shape[1]:
        raise ValueError(f"kv_len2 {kv_len2} outside [0, {k2.shape[1]}]")
    if q.device.type != "cuda":
        raise ValueError(f"kernel needs CUDA tensors, got {q.device}")
    for t in (q, *segs):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("all inputs must be contiguous on one device")
        if t.data_ptr() % 16:
            raise ValueError("q, k, v must be 16-byte aligned")


def decode_attention(q, k, v, kv_len: int, *, k2=None, v2=None,
                     kv_len2: int = 0, kv_block: int = 256,
                     scale: float | None = None):
    """Launch a CUDA kernel: same contract as
    ``decode_attention_plain``, the second segment included. The fast
    kernels take the shapes they were built for (``_fast``), the generic
    kernel the rest. ``kv_block`` must be positive; the kernels' split of
    ``kv_len + kv_len2`` keys is ``split_plan``'s (fast) or
    ``split_plan_generic``'s, which changes only the order of sums."""
    kv_len, kv_len2 = int(kv_len), int(kv_len2)
    if kv_block <= 0:
        raise ValueError(f"kv_block {kv_block} must be positive")
    _check(q, k, v, kv_len, k2, v2, kv_len2)
    if k2 is None:       # no second segment: the first again, none of it
        k2, v2 = k, v
    b, hq, d = q.shape
    skv, hkv, skv2 = k.shape[1], k.shape[2], k2.shape[1]
    n_keys = kv_len + kv_len2
    lib = _lib()
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    n_sm = _sm_count(q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), k2.data_ptr(),
            v2.data_ptr(), out.data_ptr())
    if _fast(b, hq, hkv, d, q.dtype):
        name = "decode_attention"
        chunk, n_split = split_plan(b, hkv, n_keys, n_sm)
        err = lib.decode_attention_launch(
            *ptrs, b, skv, skv2, hq, hkv, d, kv_len, kv_len2, chunk,
            n_split, float(scale), _DTYPE_CODE[q.dtype], stream)
    else:
        name = "decode_attention_generic"
        chunk, n_split = split_plan_generic(
            b * hkv * head_chunks(hq // hkv, q.dtype), n_keys, n_sm)
        n_ws = workspace_floats(b, hq, d, n_split)
        ws = (torch.empty(n_ws, dtype=torch.float32, device=q.device)
              if n_ws else None)
        err = lib.decode_attention_generic_launch(
            *ptrs, ws.data_ptr() if ws is not None else None, b, skv, skv2,
            hq, hkv, d, kv_len, kv_len2, chunk, n_split, float(scale),
            _DTYPE_CODE[q.dtype], stream)
    LAUNCHES[name] += 1
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out
