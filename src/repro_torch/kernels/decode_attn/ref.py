"""Oracle for GQA flash-decode: one query token vs a long KV cache
(PyTorch port of ``repro/kernels/decode_attn/ref.py``)."""
from __future__ import annotations

import torch


def decode_attention_ref(q, k, v, kv_len, *, scale=None):
    """q: (b, hq, d); k/v: (b, skv, hkv, d); kv_len: valid cache length."""
    b, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    kr = k.repeat_interleave(g, dim=2)
    vr = v.repeat_interleave(g, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kr.float()) * scale
    mask = torch.arange(skv, device=q.device)[None, None, :] < kv_len
    s = s.masked_fill(~mask, -torch.inf)
    m = s.amax(-1, keepdim=True)
    e = torch.where(mask, torch.exp(s - m), 0.0)
    o = torch.einsum("bhk,bkhd->bhd", e, vr.float())
    return (o / torch.clamp(e.sum(-1)[..., None], min=1e-30)).to(q.dtype)
