"""Oracle for block-sparse flash attention (PyTorch port of
``repro/kernels/block_sparse_attn/ref.py``).

Semantics: for each (batch*head, q_block) row, attention is restricted to
the kv blocks listed in block_idx[:block_cnt]; causal masking applies
inside blocks by absolute position. Rows with zero active blocks output 0.
A dense token-resolution mask, true -inf and fp32 throughout.
"""
from __future__ import annotations

import torch


def block_mask_dense(block_idx: torch.Tensor, block_cnt: torch.Tensor,
                     n_qb: int, n_kb: int) -> torch.Tensor:
    """(bh, n_qb, max_nnz) lists -> (bh, n_qb, n_kb) boolean mask."""
    bh, nq, mx = block_idx.shape
    dev = block_idx.device
    valid = torch.arange(mx, device=dev)[None, None, :] < block_cnt[..., None]
    idx = torch.where(valid, block_idx.long(), n_kb)   # padding -> dropped
    mask = torch.zeros((bh, nq, n_kb + 1), dtype=torch.bool, device=dev)
    mask.scatter_(2, idx, valid)
    return mask[..., :n_kb]


def block_sparse_attention_ref(q, k, v, block_idx, block_cnt, *,
                               causal: bool = True, q_block: int = 128,
                               kv_block: int = 128,
                               scale: float | None = None):
    """q: (bh, sq, d); k/v: (bh, skv, d) (kv already head-mapped);
    block_idx/cnt: (bh, n_qb, max_nnz) / (bh, n_qb)."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    n_qb = sq // q_block
    n_kb = skv // kv_block
    scale = scale if scale is not None else d ** -0.5
    dev = q.device

    bmask = block_mask_dense(block_idx, block_cnt, n_qb, n_kb)
    tok_mask = bmask.repeat_interleave(q_block, dim=1).repeat_interleave(
        kv_block, dim=2)                                # (bh, sq, skv)
    if causal:
        cm = (torch.arange(sq, device=dev)[:, None]
              >= torch.arange(skv, device=dev)[None, :])
        tok_mask = tok_mask & cm

    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    s = s.masked_fill(~tok_mask, -torch.inf)
    row_any = tok_mask.any(-1)
    m = torch.where(row_any, s.amax(-1), 0.0)
    p = torch.exp(s - m[..., None])
    p = torch.where(tok_mask, p, 0.0)
    l = p.sum(-1)
    o = torch.einsum("bqk,bkd->bqd", p, v.float())
    o = o / torch.clamp(l, min=1e-30)[..., None]
    o = torch.where(row_any[..., None], o, 0.0)
    return o.to(q.dtype)
