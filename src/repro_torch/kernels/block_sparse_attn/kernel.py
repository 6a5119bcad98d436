"""Block-sparse flash attention: the CUDA kernel and its plain PyTorch
version.

The kernel (``csrc/block_sparse_attn.cu``) replaces the Pallas kernel of
``repro/kernels/block_sparse_attn/kernel.py``. ``block_sparse_attention``
launches it on CUDA tensors; each launch adds one to ``LAUNCHES``. The
source holds one kernel for each dtype, and the launch dispatches on it:
bf16 runs on the tensor cores (``mma.sync``, 16 to 128 query rows a
CTA), fp32 on the CUDA cores, whose fp32 products the fp32 tolerance
needs. Neither stands in for the other. ``supported`` states, without a
card, which head shapes the kernels take: head sizes 64, 80, 128 and 256
(every attention-bearing config of ``repro_torch.configs``) and any
group; the reference takes any head size. ``supported_blocks`` states
which block sizes they take: any q_block and kv_block that are positive
multiples of 16 (every block size of the repo's configs, CLIs and
tests); the reference takes any.
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

LAUNCHES = {"block_sparse_attention": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (64, 80, 128, 256)
_SEG = 16            # block sizes are multiples of it (mma.sync's m16)


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
        _LIB = lib
    return _LIB


def supported(hq: int, hkv: int, d: int, dtype) -> bool:
    """Whether the kernels take hq query heads over hkv kv heads of head
    size d in ``dtype``: d in ``_HEAD_DIMS``, any group hq / hkv, fp32 or
    bf16. Needs no card."""
    return (hkv >= 1 and hq >= hkv and hq % hkv == 0 and d in _HEAD_DIMS
            and dtype in _DTYPES)


def supported_blocks(q_block: int, kv_block: int) -> bool:
    """Whether the kernels take q-blocks of `q_block` rows and kv blocks of
    `kv_block` rows: positive multiples of 16. Needs no card."""
    return all(b > 0 and b % _SEG == 0 for b in (q_block, kv_block))


def _check(q, k, v, block_idx, block_cnt, q_block, kv_block, kv_group):
    if q.device.type != "cuda":
        raise ValueError(f"kernel needs CUDA tensors, got {q.device}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError("q must be (bh, sq, d) and k, v (bh_kv, skv, d)")
    bh, sq, d = q.shape
    bh_kv, skv, dk = k.shape
    if dk != d or kv_group < 1 or bh != bh_kv * kv_group:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         f"not match with kv_group {kv_group}")
    if not supported(bh, bh_kv, d, q.dtype):
        raise ValueError(f"head size {d} in {q.dtype}: the kernels take "
                         f"head sizes {_HEAD_DIMS} in {_DTYPES}")
    if not supported_blocks(q_block, kv_block):
        raise ValueError(f"q_block {q_block} and kv_block {kv_block} must "
                         f"be positive multiples of {_SEG}")
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
    for t in (q, k, v, block_idx, block_cnt):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("all inputs must be contiguous on one device")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must be 16-byte aligned")
    if bh >= 65536:
        raise ValueError(f"bh {bh} exceeds the kernel's grid")


def _cta_rows(q_block: int, dtype) -> int:
    """Query rows a CTA takes, all of one q-block: the most of 128 (the
    tensor-core kernel's 8 warps of 16 rows; at d = 256 a CTA of 128 rows
    holds 192 KB of shared memory, one CTA an SM), 64, 32 and 16 that
    divides q_block; the fp32 kernel at most 64."""
    top = 128 if dtype == torch.bfloat16 else 64
    return next(r for r in (128, 64, 32, 16) if r <= top and q_block % r == 0)


def block_sparse_attention(q, k, v, block_idx, block_cnt, *,
                           causal: bool = True, q_block: int = 128,
                           kv_block: int = 128, scale: float | None = None,
                           kv_group: int = 1):
    """Launch the CUDA kernel: same contract as
    ``block_sparse_attention_plain``. List entries outside [0, skv //
    kv_block) are skipped rather than read."""
    _check(q, k, v, block_idx, block_cnt, q_block, kv_block, kv_group)
    lib = _lib()
    bh, sq, d = q.shape
    skv = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.block_sparse_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), block_idx.data_ptr(),
        block_cnt.data_ptr(), out.data_ptr(), bh, sq, skv, d,
        sq // q_block, block_idx.shape[-1], q_block, kv_block, kv_group,
        int(causal), float(scale), int(q.dtype == torch.bfloat16),
        _cta_rows(q_block, q.dtype), stream)
    LAUNCHES["block_sparse_attention"] += 1
    if err:
        raise RuntimeError(f"block_sparse_attention launch failed: CUDA "
                           f"error {err}")
    return out
