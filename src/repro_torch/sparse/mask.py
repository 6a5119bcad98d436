"""Block importance estimation -> sparse block lists (PyTorch port of
``repro/sparse/mask.py``).

Mean-pooled q/k block representatives score every (q_block, kv_block)
pair; per q row, blocks are kept in descending-score order until their
(softmax-normalized) cumulative mass reaches `mass`; the diagonal (local)
block and block 0 (attention sink) are always kept. The order is a
stable sort, as ``jnp.argsort`` is, so tied scores keep index order.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def pool_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """(bh, s, d) -> (bh, s//block, d) mean pool."""
    bh, s, d = x.shape
    return x.reshape(bh, s // block, block, d).mean(dim=2)


def block_scores(q, k, *, q_block: int, kv_block: int,
                 causal: bool = True) -> torch.Tensor:
    """(bh, n_qb, n_kb) pooled attention scores; invalid blocks -inf."""
    pq = pool_blocks(q, q_block).float()
    pk = pool_blocks(k, kv_block).float()
    s = torch.einsum("bqd,bkd->bqk", pq, pk) * (q.shape[-1] ** -0.5)
    if causal:
        n_qb, n_kb = s.shape[1], s.shape[2]
        # block (qb, kb) is causal-valid if its first q row can see the
        # block's first kv position: qb*q_block + q_block-1 >= kb*kv_block
        qend = (torch.arange(n_qb, device=s.device) + 1) * q_block - 1
        kstart = torch.arange(n_kb, device=s.device) * kv_block
        valid = qend[:, None] >= kstart[None, :]
        s = s.masked_fill(~valid[None], -torch.inf)
    return s


def select_blocks(scores: torch.Tensor, *, mass: float = 0.98,
                  always_keep_diag: bool = True, q_block: int = 128,
                  kv_block: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """scores: (bh, n_qb, n_kb) -> (block_idx, block_cnt) int32 padded
    lists. Keeps the top blocks whose softmax mass reaches `mass` per row.
    """
    bh, n_qb, n_kb = scores.shape
    dev = scores.device
    p = torch.softmax(scores, dim=-1)
    p = torch.where(torch.isfinite(scores), p, 0.0)

    if always_keep_diag:
        diag = torch.clamp((torch.arange(n_qb, device=dev) * q_block)
                           // kv_block, max=n_kb - 1)
        boost = F.one_hot(diag, n_kb) + F.one_hot(
            torch.zeros_like(diag), n_kb)
        p = p + boost[None].to(p.dtype)                # force to the front

    order = torch.argsort(-p, dim=-1, stable=True)     # (bh, n_qb, n_kb)
    p_sorted = torch.gather(p, -1, order)
    denom = torch.clamp(p_sorted.sum(-1, keepdim=True), min=1e-9)
    cum = torch.cumsum(p_sorted, dim=-1) / denom
    # keep k blocks where the mass BEFORE them is < mass and score > 0
    before = torch.cat([torch.zeros_like(cum[..., :1]), cum[..., :-1]],
                       dim=-1)
    keep = (before < mass) & (p_sorted > 0)
    cnt = keep.sum(-1).to(torch.int32)
    idx = torch.where(keep, order, 0).to(torch.int32)
    return idx, cnt


def trim_nnz(block_idx, block_cnt, multiple: int = 1):
    """Host-side: shrink the padded nnz dimension to max(cnt)."""
    block_idx = np.asarray(torch.as_tensor(block_idx).cpu())
    block_cnt = np.asarray(torch.as_tensor(block_cnt).cpu())
    mx = int(max(int(np.max(block_cnt)), 1))
    mx = ((mx + multiple - 1) // multiple) * multiple
    return block_idx[..., :mx], block_cnt


def active_block_fraction(block_cnt, n_kb: int,
                          causal: bool = True) -> float:
    """Mean density vs the causal-valid block count (diagnostics)."""
    cnt = np.asarray(torch.as_tensor(block_cnt).cpu())
    n_qb = cnt.shape[1]
    if causal:
        valid = np.minimum(np.arange(1, n_qb + 1) * (128 // 128), n_kb)
        valid = np.maximum(valid, 1)
        return float(np.mean(cnt / valid[None, :]))
    return float(np.mean(cnt / n_kb))
