"""Shared model building blocks, dense subset (PyTorch).

Port of ``repro/models/layers.py``. Tensors keep the reference layouts:
activations (b, s, d), heads (b, s, h, hd), stacked weights as in the
reference's param tree. Activations are in the parameters' dtype (bf16
on the card); softmax statistics in fp32. The attention is the
reference's chunked flash attention (a loop over kv blocks with a
running softmax), so a long prefill never holds an S x S score matrix.
The sharding constraints of the reference are the identity on one device
and are dropped.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# ----------------------------------------------------------------------------
# Parameter declaration
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    init: str = "normal"  # normal | zeros | ones
    scale: float = 0.02
    dtype: str = "bfloat16"


def init_params(defs, generator: torch.Generator, device):
    """Draw a param tree from `defs` (leaves in sorted-key order) with the
    reference's scales: N(0, 1) * scale, zeros or ones."""
    if isinstance(defs, ParamDef):
        dt = _DTYPES[defs.dtype]
        if defs.init == "zeros":
            return torch.zeros(defs.shape, dtype=dt, device=device)
        if defs.init == "ones":
            return torch.ones(defs.shape, dtype=dt, device=device)
        if defs.init == "normal":
            w = torch.randn(defs.shape, generator=generator,
                            dtype=torch.float32, device=device)
            return (w * defs.scale).to(dt)
        raise ValueError(defs.init)
    return {k: init_params(defs[k], generator, device) for k in sorted(defs)}


def norm_defs(cfg, d: int, prefix_shape=()) -> dict:
    defs = {"scale": ParamDef(prefix_shape + (d,), init="zeros")}
    if cfg.norm == "layernorm":
        defs["bias"] = ParamDef(prefix_shape + (d,), init="zeros")
    return defs


def attention_defs(cfg, *, stacked: int = 0) -> dict:
    d, hq, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    pre = (stacked,) if stacked else ()
    defs = {
        "wq": ParamDef(pre + (d, hq, hd)),
        "wk": ParamDef(pre + (d, hkv, hd)),
        "wv": ParamDef(pre + (d, hkv, hd)),
        "wo": ParamDef(pre + (hq, hd, d),
                       scale=0.02 / np.sqrt(2 * max(cfg.num_layers, 1))),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef(pre + (hq, hd), init="zeros")
        defs["bk"] = ParamDef(pre + (hkv, hd), init="zeros")
        defs["bv"] = ParamDef(pre + (hkv, hd), init="zeros")
    return defs


def mlp_defs(cfg, *, stacked: int = 0, d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    pre = (stacked,) if stacked else ()
    defs = {
        "w_up": ParamDef(pre + (d, f)),
        "w_down": ParamDef(pre + (f, d),
                           scale=0.02 / np.sqrt(2 * max(cfg.num_layers, 1))),
    }
    if cfg.activation in ("swiglu", "geglu"):
        defs["w_gate"] = ParamDef(pre + (d, f))
    return defs


# ----------------------------------------------------------------------------
# Norms / activations / RoPE
# ----------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-6):
    """Statistics in fp32, application in x.dtype."""
    var = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + scale.to(x.dtype))


def layer_norm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    mu = mu.to(x.dtype)
    return (x - mu) * inv * (1.0 + scale.to(x.dtype)) + bias.to(x.dtype)


def apply_norm(cfg, x, p):
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def act_fn(name: str):
    if name in ("swiglu", "silu"):
        return F.silu
    if name in ("geglu", "gelu"):
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


def rope(x, positions, theta: float):
    """Rotary embedding, llama-style half rotation.

    x: (..., s, h, d); positions: broadcastable to (..., s).
    """
    d = x.shape[-1]
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    ang = positions.to(torch.float32)[..., None] * freqs   # (..., s, half)
    cos = torch.cos(ang)[..., None, :]                      # (..., s, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Chunked flash attention
# ----------------------------------------------------------------------------


def flash_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                    kv_len: Optional[int] = None, kv_chunk: int = 1024,
                    scale: Optional[float] = None,
                    return_stats: bool = False):
    """Memory-efficient attention with GQA support.

    q: (b, sq, hq, d); k/v: (b, skv, hkv, d), hq % hkv == 0.
    kv_len: optional valid length (decode); default skv.
    Returns (b, sq, hq, d) in q.dtype, plus (m, l) of shape (b, hq, sq)
    with `return_stats`. GQA repeats the kv heads to hq, as the
    reference does.
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    kv_chunk = min(kv_chunk, skv)
    dev = q.device
    q_pos = q_offset + torch.arange(sq, device=dev)
    if kv_len is None:
        kv_len = skv

    nc = -(-skv // kv_chunk)
    pad = nc * kv_chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))

    m = torch.full((b, hq, sq), -torch.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=dev)
    for i in range(nc):
        start = i * kv_chunk
        kc = k[:, start:start + kv_chunk]
        vc = v[:, start:start + kv_chunk]
        # the score matmul rounds to the activation dtype, as the
        # reference's bf16 einsum does, then scales in fp32
        s = torch.einsum("bqhd,bkhd->bhqk", q, kc).float() * scale
        kv_pos = start + torch.arange(kv_chunk, device=dev)
        mask = kv_pos[None, :] < kv_len
        if causal:
            mask = mask & (q_pos[:, None] >= kv_pos[None, :])
        s = s.masked_fill(~mask, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        # guard fully-masked rows (m_new == -inf)
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(-1)
        # probabilities in v's dtype, products accumulated in fp32
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                          vc.float())
        acc = acc * corr[..., None] + pv
        m = m_new

    out = acc / torch.clamp(l, min=1e-37)[..., None]         # (b,hq,sq,d)
    out = out.movedim(2, 1)
    if return_stats:
        return out.to(q.dtype), m, l
    return out.to(q.dtype)


def merge_attention(parts):
    """Combine flash partials [(out, m, l), ...] over disjoint kv sets.

    out: (b, s, h, d); m/l: (b, h, s)."""
    m_star = torch.stack([m for _, m, _ in parts]).amax(0)
    num = 0.0
    den = 0.0
    for out, m, l in parts:
        w = (l * torch.exp(m - m_star)).movedim(1, 2)         # (b,s,h)
        num = num + w[..., None] * out.float()
        den = den + w
    out = num / torch.clamp(den, min=1e-37)[..., None]
    return out.to(parts[0][0].dtype)


# ----------------------------------------------------------------------------
# Attention and MLP
# ----------------------------------------------------------------------------


def attention_qkv(cfg, p, x, positions=None, *, use_rope: bool = True):
    """Project to q, k, v (+bias, +rope). x: (b, s, d)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if use_rope and positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_out(p, o):
    """o: (b, s, hq, hd) -> (b, s, d)."""
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def mlp_block(cfg, p, x):
    act = act_fn(cfg.activation)
    up = torch.einsum("bsd,df->bsf", x, p["w_up"])
    if "w_gate" in p:
        gate = torch.einsum("bsd,df->bsf", x, p["w_gate"])
        h = act(gate) * up
    else:
        h = act(up)
    return torch.einsum("bsf,fd->bsd", h, p["w_down"])
