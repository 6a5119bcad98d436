"""Block-sparse flash attention: the CUDA kernel and its plain PyTorch
version.

The kernels (``csrc/block_sparse_attn.cu``) replace the Pallas kernel of
``repro/kernels/block_sparse_attn/kernel.py``. ``block_sparse_attention``
launches one of them on CUDA tensors, chosen by shape before the launch:

- the fast kernels, where ``_tc_supported`` and ``_tc_blocks`` hold
  (head sizes 64, 80, 128 and 256, every attention-bearing config of
  ``repro_torch.configs``; blocks that are multiples of 16): bf16 and
  fp16 on the tensor cores (``mma.sync``, 16 to 128 query rows a CTA),
  fp32 on the CUDA cores, whose fp32 products the fp32 tolerance needs.
  Each launch adds one to ``LAUNCHES["block_sparse_attention"]``;
- the generic kernel for every other shape the reference takes: any head
  size up to ``_GENERIC_MAX_D``, any q_block and kv_block, fp32, bf16 or
  fp16. A CTA takes up to 64 rows of a q-block (32 in fp32), stages each
  64-key sub-tile of its list (32 in fp32) once for all of them, and
  computes on the tensor cores in bf16 and fp16, on the CUDA cores in fp32
  (``kernels/_generic.py``). Each launch adds one to
  ``LAUNCHES["block_sparse_attention_generic"]``.

``supported(hq, hkv, d, dtype)`` and ``supported_blocks(q_block,
kv_block)`` state, without a card, what the port takes on the card: what
the reference's contract takes (hq a multiple of hkv; positive blocks),
up to the generic kernel's head-size limit, in fp32, bf16 and fp16.
``block_sparse_attention_plain`` computes what the Pallas kernel computes
with torch ops: per (head, q-block) the online softmax over the listed kv
blocks in list order, scores in fp32, p rounded to v's dtype before the
PV product. The CPU path takes it (``ops.py`` dispatches on the tensor's
device); the card never does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"block_sparse_attention": 0,
            "block_sparse_attention_generic": 0}

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_DTYPE_CODE = {dt: i for i, dt in enumerate(_DTYPES)}    # the C code's
_HEAD_DIMS = (64, 80, 128, 256)    # the fast kernels' head sizes
_SEG = 16            # the fast kernels' blocks are multiples of it (m16)
# the generic kernel's head sizes: 1 to this (past 256, 16 CTAs a row
# block, each owning 256 of O's columns)
_GENERIC_MAX_D = 4096
_MAX_GRID_Y = 65535  # the tensor-core kernels' row blocks (gridDim.y)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------------------------
# Plain version
# ----------------------------------------------------------------------------


def block_sparse_attention_plain(q, k, v, block_idx, block_cnt, *,
                                 causal: bool = True, q_block: int = 128,
                                 kv_block: int = 128,
                                 scale: float | None = None,
                                 kv_group: int = 1):
    """q: (bh, sq, d); k/v: (bh // kv_group, skv, d); block_idx
    (bh, n_qb, max_nnz) int32; block_cnt (bh, n_qb) int32 -> (bh, sq, d).

    Every q-block steps through its list together, one list entry per
    step, so memory stays at a few (bh, n_qb, block, d) tensors."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    n_qb, n_kb = sq // q_block, skv // kv_block
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    qf = q.float().reshape(bh, n_qb, q_block, d)
    kt = k.reshape(-1, n_kb, kv_block, d)
    vt = v.reshape(-1, n_kb, kv_block, d)
    kv_row = (torch.arange(bh, device=dev) // kv_group)[:, None]
    qpos = (torch.arange(n_qb, device=dev)[:, None] * q_block
            + torch.arange(q_block, device=dev)[None, :])   # (n_qb, q_block)
    koff = torch.arange(kv_block, device=dev)

    m = torch.full((bh, n_qb, q_block), -torch.inf, device=dev)
    l = torch.zeros((bh, n_qb, q_block), device=dev)
    acc = torch.zeros((bh, n_qb, q_block, d), device=dev)
    steps = int(block_cnt.max()) if block_cnt.numel() else 0
    for j in range(min(steps, block_idx.shape[-1])):
        active = block_cnt > j                                 # (bh, n_qb)
        kb = torch.where(active, block_idx[..., j], 0).long()
        s = torch.einsum("bnqd,bnkd->bnqk", qf,
                         kt[kv_row, kb].float()) * scale
        mask = active[..., None, None]
        if causal:
            kpos = kb[..., None] * kv_block + koff             # (bh, n_qb, kb)
            mask = mask & (qpos[None, :, :, None] >= kpos[:, :, None, :])
        s = s.masked_fill(~mask, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bnqk,bnkd->bnqd", p.to(v.dtype).float(),
                          vt[kv_row, kb].float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = torch.where(l[..., None] > 0,
                      acc / torch.clamp(l, min=1e-30)[..., None], 0.0)
    return out.reshape(bh, sq, d).to(q.dtype)


def listed_blocks(block_idx, block_cnt, n_kb: int):
    """The lists that the kernel walks in (block_idx, block_cnt): the
    entries before the count (at most the list's length) that lie in
    [0, n_kb), in list order, packed to the front with their count. The
    plain version reads every entry it is given, so it takes these to
    compute what the kernel computes from lists with such holes."""
    nnz = block_idx.shape[-1]
    listed = (torch.arange(nnz, device=block_idx.device)
              < block_cnt.clamp(max=nnz)[..., None])
    keep = listed & (block_idx >= 0) & (block_idx < n_kb)
    order = torch.argsort((~keep).int(), dim=-1, stable=True)
    idx = torch.gather(block_idx, -1, order).clamp(0, n_kb - 1)
    return idx, keep.sum(-1, dtype=torch.int32)


# ----------------------------------------------------------------------------
# CUDA launcher
# ----------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("block_sparse_attn")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.block_sparse_attention_launch.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, ctypes.c_float,
            i, i, p]
        lib.block_sparse_attention_launch.restype = i
        lib.block_sparse_attention_generic_launch.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, ctypes.c_float,
            i, p]
        lib.block_sparse_attention_generic_launch.restype = i
        _LIB = lib
    return _LIB


def supported(hq: int, hkv: int, d: int, dtype) -> bool:
    """Whether the port takes hq query heads over hkv kv heads of head
    size d in ``dtype`` on the card: hq a multiple of hkv (the reference's
    ``bh == bh_kv * kv_group``), d from 1 to ``_GENERIC_MAX_D``, fp32,
    bf16 or fp16. Needs no card."""
    return (hkv >= 1 and hq >= hkv and hq % hkv == 0
            and 1 <= d <= _GENERIC_MAX_D and dtype in _DTYPES)


def supported_blocks(q_block: int, kv_block: int) -> bool:
    """Whether the port takes q-blocks of `q_block` rows and kv blocks of
    `kv_block` rows on the card: any positive sizes. Needs no card."""
    return q_block > 0 and kv_block > 0


def _tc_supported(hq: int, hkv: int, d: int, dtype) -> bool:
    """Whether the fast kernels take the head shape: d in
    ``_HEAD_DIMS``."""
    return supported(hq, hkv, d, dtype) and d in _HEAD_DIMS


def _tc_blocks(q_block: int, kv_block: int) -> bool:
    """Whether the fast kernels take the blocks: positive multiples of
    16."""
    return all(b > 0 and b % _SEG == 0 for b in (q_block, kv_block))


def _fast(bh, bh_kv, sq, d, dtype, q_block, kv_block) -> bool:
    """The shape test that picks the kernel before the launch: the fast
    kernels where they take the head shape, the blocks and the grid (row
    blocks on gridDim.y for bf16 and fp16, bh * row blocks on gridDim.x
    for fp32)."""
    if not (_tc_supported(bh, bh_kv, d, dtype)
            and _tc_blocks(q_block, kv_block)):
        return False
    n_rb = sq // _cta_rows(q_block, dtype)
    return (n_rb <= _MAX_GRID_Y if dtype != torch.float32
            else bh * n_rb < 2 ** 31)


def _check(q, k, v, block_idx, block_cnt, q_block, kv_block, kv_group):
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError("q must be (bh, sq, d) and k, v (bh_kv, skv, d)")
    bh, sq, d = q.shape
    bh_kv, skv, dk = k.shape
    if dk != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in head size")
    if bh_kv < 1 or kv_group < 1 or bh != bh_kv * kv_group:
        raise ValueError(f"bh {bh} must be bh_kv {bh_kv} * kv_group "
                         f"{kv_group}, with at least one kv row")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype}: the kernels take {_DTYPES}")
    if not 1 <= d <= _GENERIC_MAX_D:
        raise ValueError(f"head size {d}: the kernels take 1 to "
                         f"{_GENERIC_MAX_D}, the generic kernel's limit")
    if not supported_blocks(q_block, kv_block):
        raise ValueError(f"q_block {q_block} and kv_block {kv_block} must "
                         "be positive")
    if sq % q_block or skv % kv_block:
        raise ValueError(f"sq {sq} must be a multiple of q_block {q_block} "
                         f"and skv {skv} of kv_block {kv_block}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of {_DTYPES}")
    n_qb = sq // q_block
    if (block_idx.dtype != torch.int32 or block_cnt.dtype != torch.int32
            or block_idx.dim() != 3
            or tuple(block_idx.shape[:2]) != (bh, n_qb)
            or tuple(block_cnt.shape) != (bh, n_qb)):
        raise ValueError(f"block_idx must be int32 (bh, {n_qb}, max_nnz) "
                         f"and block_cnt int32 ({bh}, {n_qb})")
    if q.device.type != "cuda":
        raise ValueError(f"kernel needs CUDA tensors, got {q.device}")
    for t in (q, k, v, block_idx, block_cnt):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("all inputs must be contiguous on one device")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must be 16-byte aligned")


def _cta_rows(q_block: int, dtype) -> int:
    """Query rows a CTA of the fast kernels takes, all of one q-block: the
    most of 128 (the tensor-core kernel's 8 warps of 16 rows; at d = 256 a
    CTA of 128 rows holds 192 KB of shared memory, one CTA an SM), 64, 32
    and 16 that divides q_block (a multiple of 16); the fp32 kernel at
    most 64."""
    top = 64 if dtype == torch.float32 else 128
    return next(r for r in (128, 64, 32, 16) if r <= top and q_block % r == 0)


def block_sparse_attention(q, k, v, block_idx, block_cnt, *,
                           causal: bool = True, q_block: int = 128,
                           kv_block: int = 128, scale: float | None = None,
                           kv_group: int = 1):
    """Launch a CUDA kernel: same contract as
    ``block_sparse_attention_plain``. The fast kernels take the shapes
    they were built for (``_fast``), the generic kernel the rest. List
    entries outside [0, skv // kv_block) are skipped rather than read."""
    _check(q, k, v, block_idx, block_cnt, q_block, kv_block, kv_group)
    lib = _lib()
    bh, sq, d = q.shape
    skv = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), block_idx.data_ptr(),
            block_cnt.data_ptr(), out.data_ptr(), bh, sq, skv, d,
            sq // q_block, block_idx.shape[-1], q_block, kv_block, kv_group,
            int(causal), float(scale), _DTYPE_CODE[q.dtype])
    if _fast(bh, k.shape[0], sq, d, q.dtype, q_block, kv_block):
        name = "block_sparse_attention"
        err = lib.block_sparse_attention_launch(
            *args, _cta_rows(q_block, q.dtype), stream)
    else:
        name = "block_sparse_attention_generic"
        err = lib.block_sparse_attention_generic_launch(*args, stream)
    LAUNCHES[name] += 1
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out
