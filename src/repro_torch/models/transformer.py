"""Decoder-only transformer LM, dense family (PyTorch).

Port of ``repro/models/transformer.py``. The reference scans stacked
layer params with ``lax.scan``; here an eager loop indexes layer l of
each stacked tensor. The MoE family is not ported yet (ROADMAP.md,
queue 1, item 10).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.layers import ParamDef

# capacity of the decode tail buffer (newly generated tokens); the
# context cache stays read-only, as in the reference
DECODE_TAIL = 128


def param_defs(cfg) -> dict:
    n = cfg.num_layers
    defs = {
        "emb": ParamDef((cfg.padded_vocab, cfg.d_model)),
        "final_norm": L.norm_defs(cfg, cfg.d_model),
        "blocks": {
            "attn_norm": L.norm_defs(cfg, cfg.d_model, prefix_shape=(n,)),
            "mlp_norm": L.norm_defs(cfg, cfg.d_model, prefix_shape=(n,)),
            "attn": L.attention_defs(cfg, stacked=n),
            "mlp": L.mlp_defs(cfg, stacked=n),
        },
    }
    if not cfg.tie_embeddings:
        defs["unemb"] = ParamDef((cfg.d_model, cfg.padded_vocab))
    return defs


def layer_params(blocks: dict, l: int) -> dict:
    """Layer l of a stacked param subtree."""
    return {k: layer_params(v, l) if isinstance(v, dict) else v[l]
            for k, v in blocks.items()}


def decode_attention(cfg, bp_attn, q, k, v, ctx_k, ctx_v, tail_k, tail_v,
                     tail_pos: int):
    """Attend a single new token over [static context] + [tail buffer].

    ctx_*: (b, cap, hkv, hd) read-only; tail_*: (b, DECODE_TAIL, hkv, hd).
    The new (k, v) is written at tail_pos IN PLACE (the reference returns
    updated copies). Returns (o, tail_k, tail_v)."""
    if not 0 <= tail_pos < tail_k.shape[1]:
        raise ValueError(f"decode position {tail_pos} outside the "
                         f"{tail_k.shape[1]}-token tail buffer")
    tail_k[:, tail_pos] = k[:, 0]
    tail_v[:, tail_pos] = v[:, 0]
    p1 = L.flash_attention(q, ctx_k, ctx_v, causal=False,
                           kv_chunk=max(cfg.attn_chunk, 2048),
                           return_stats=True)
    p2 = L.flash_attention(q, tail_k, tail_v, causal=False,
                           kv_len=tail_pos + 1, kv_chunk=DECODE_TAIL,
                           return_stats=True)
    o = L.merge_attention([p1, p2])
    return o, tail_k, tail_v


def _block(cfg, bp, x, positions, *, causal=True, kv_cache=None, pos=None):
    """One transformer block. Returns (x, (k, v) | tail buffers, aux)."""
    h = L.apply_norm(cfg, x, bp["attn_norm"])
    q, k, v = L.attention_qkv(cfg, bp["attn"], h, positions)
    if kv_cache is None:
        o = L.flash_attention(q, k, v, causal=causal,
                              kv_chunk=cfg.attn_chunk)
        new_kv = (k, v)
    else:
        ctx_k, ctx_v, tail_k, tail_v = kv_cache
        tail_pos = pos - ctx_k.shape[1]
        o, tail_k, tail_v = decode_attention(
            cfg, bp["attn"], q, k, v, ctx_k, ctx_v, tail_k, tail_v,
            tail_pos)
        new_kv = (tail_k, tail_v)
    x = x + L.attention_out(bp["attn"], o)
    h = L.apply_norm(cfg, x, bp["mlp_norm"])
    x = x + L.mlp_block(cfg, bp["mlp"], h)
    return x, new_kv, 0.0


def forward(cfg, params, tokens, *, collect_kv: bool = False):
    """Full causal forward. tokens: (b, s) int.

    Returns (x_final, (k_stack, v_stack) | None, aux_sum); the stacks are
    (L, b, s, hkv, hd). x_final is post-final-norm."""
    x = params["emb"][tokens]
    positions = torch.arange(tokens.shape[1], device=x.device)
    ks, vs = [], []
    for l in range(cfg.num_layers):
        x, (k, v), _ = _block(cfg, layer_params(params["blocks"], l), x,
                              positions)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = L.apply_norm(cfg, x, params["final_norm"])
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return x, kvs, 0.0


def unembed(cfg, params, x):
    w = params["emb"].T if cfg.tie_embeddings else params["unemb"]
    return torch.einsum("bsd,dv->bsv", x, w)


def prefill(cfg, params, tokens):
    """Returns (last-position logits (b, v), kv cache stack (L,b,s,hkv,hd) x2)."""
    x, kvs, _ = forward(cfg, params, tokens, collect_kv=True)
    logits = unembed(cfg, params, x[:, -1:, :])[:, 0, :]
    return logits, {"k": kvs[0], "v": kvs[1]}


def init_cache(cfg, batch: int, capacity: int, *, device,
               dtype=torch.bfloat16):
    """capacity = context length (read-only); newly decoded tokens live in
    the DECODE_TAIL buffer."""
    shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    tail = (cfg.num_layers, batch, DECODE_TAIL, cfg.num_kv_heads,
            cfg.resolved_head_dim)
    z = lambda s: torch.zeros(s, dtype=dtype, device=device)
    return {"k": z(shape), "v": z(shape), "tail_k": z(tail),
            "tail_v": z(tail)}


def decode_step(cfg, params, cache, token, pos: int):
    """One decode step. token: (b,) int; pos: global position
    (pos >= context capacity; the new token goes to the tail buffer).
    Updates cache's tail buffers in place and returns (logits, cache)."""
    x = params["emb"][token[:, None]]                          # (b, 1, d)
    positions = torch.full((1,), pos, device=x.device)
    for l in range(cfg.num_layers):
        x, _, _ = _block(cfg, layer_params(params["blocks"], l), x,
                         positions,
                         kv_cache=(cache["k"][l], cache["v"][l],
                                   cache["tail_k"][l], cache["tail_v"][l]),
                         pos=pos)
    x = L.apply_norm(cfg, x, params["final_norm"])
    logits = unembed(cfg, params, x)[:, 0, :]
    return logits, cache
