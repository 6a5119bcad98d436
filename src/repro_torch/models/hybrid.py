"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention
block applied every `attn_every` layers (the same parameters each time,
a KV cache of its own for each application) [arXiv:2411.15242]
(PyTorch).

Port of ``repro/models/hybrid.py``. The reference reshapes the stacked
Mamba2 params to (groups, attn_every, ...) and scans them; here group g
takes layers g * attn_every ... (g + 1) * attn_every - 1 of the stacks.
``decode_step`` returns a new cache and leaves the one it is given
untouched, as the reference does: new conv and state tensors, and the
attention tails copied before the new token is written into them.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models import mamba_lm
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.layers import ParamDef
from repro_torch.spans import span


# the shared block's decode tails, one row an application
TAILS = ("attn_tail_k", "attn_tail_v")


def n_attn_apps(cfg) -> int:
    return cfg.num_layers // cfg.attn_every


def param_defs(cfg) -> dict:
    n = cfg.num_layers
    if n % cfg.attn_every:
        raise ValueError(f"{n} layers are not whole groups of "
                         f"{cfg.attn_every}")
    return {
        "emb": ParamDef((cfg.padded_vocab, cfg.d_model), ("vocab", "embed")),
        "final_norm": L.norm_defs(cfg, cfg.d_model),
        "blocks": {
            "norm": L.norm_defs(cfg, cfg.d_model, prefix_shape=(n,)),
            "ssm": ssm.ssm_defs(cfg, stacked=n),
        },
        "shared": {
            "attn_norm": L.norm_defs(cfg, cfg.d_model),
            "mlp_norm": L.norm_defs(cfg, cfg.d_model),
            "attn": L.attention_defs(cfg),
            "mlp": L.mlp_defs(cfg),
        },
    }


def _group_layers(cfg, g: int) -> range:
    """The Mamba2 layers of group g."""
    return range(g * cfg.attn_every, (g + 1) * cfg.attn_every)


def _shared_attn(cfg, sp, x, positions, *, kv_cache=None, pos=None):
    """The shared attention + MLP block. Prefill: causal self-attention,
    returns (x, (k, v)). Decode: kv_cache = (ctx_k, ctx_v, tail_k,
    tail_v), the new (k, v) written into the tails in place at
    pos - context length; returns (x, (tail_k, tail_v))."""
    h = L.apply_norm(cfg, x, sp["attn_norm"])
    q, k, v = L.attention_qkv(cfg, sp["attn"], h, positions)
    if kv_cache is None:
        o = L.flash_attention(q, k, v, causal=True, kv_chunk=cfg.attn_chunk)
        new_kv = (k, v)
    else:
        ctx_k, ctx_v, tail_k, tail_v = kv_cache
        o, tail_k, tail_v = T.decode_attention(
            cfg, sp["attn"], q, k, v, ctx_k, ctx_v, tail_k, tail_v,
            pos - ctx_k.shape[1])
        new_kv = (tail_k, tail_v)
    x = constrain(x + L.attention_out(sp["attn"], o),
                  "batch", "block_seq", None)
    h = L.apply_norm(cfg, x, sp["mlp_norm"])
    with (span("decode.step.ffn") if kv_cache is not None
          else contextlib.nullcontext()):
        y = L.mlp_block(cfg, sp["mlp"], h)
    return constrain(x + y, "batch", "block_seq", None), new_kv


def forward(cfg, params, tokens, *, collect: bool = False):
    """-> (x_final, (per-layer ssm caches, per-group (k, v)) | None)."""
    x = constrain(params["emb"][tokens], "batch", "block_seq", None)
    positions = torch.arange(tokens.shape[1], device=x.device)
    blocks = T.unstack(params["blocks"])
    # the shared block is rematerialized too, as in the reference: its
    # per-kv-chunk softmax residuals would otherwise dominate train memory
    inner = T._remat(cfg, lambda bp, x: mamba_lm.ssm_layer(
        cfg, bp, x, return_state=collect))
    shared = T._remat(cfg, lambda x: _shared_attn(cfg, params["shared"], x,
                                                  positions))
    ssm_caches, kvs = [], []
    for g in range(n_attn_apps(cfg)):
        for l in _group_layers(cfg, g):
            x, c = inner(blocks[l], x)
            ssm_caches.append(c)
        x, kv = shared(x)
        kvs.append(kv)
    x = L.apply_norm(cfg, x, params["final_norm"])
    return x, (ssm_caches, kvs) if collect else None


def loss_fn(cfg, params, batch):
    inp, labels, mask = T.next_token_batch(batch)
    x, _ = forward(cfg, params, inp)
    return T.softmax_xent(cfg, params, x, labels, mask) \
        / torch.clamp(mask.sum(), min=1.0)


def prefill(cfg, params, tokens):
    """-> (last-position logits, {"ssm": {"conv", "state"} stacked over
    all layers, "attn_k"/"attn_v": (groups, b, s, hkv, hd)})."""
    x, (ssm_caches, kvs) = forward(cfg, params, tokens, collect=True)
    logits = T.unembed(cfg, params, x[:, -1:, :])[:, 0, :]
    return logits, {"ssm": mamba_lm.stack_caches(ssm_caches),
                    "attn_k": torch.stack([k for k, _ in kvs]),
                    "attn_v": torch.stack([v for _, v in kvs])}


def init_cache(cfg, batch: int, capacity: int, *, device,
               dtype=torch.bfloat16):
    g = n_attn_apps(cfg)
    kv = (g, batch, capacity, cfg.num_kv_heads, cfg.resolved_head_dim)
    z = lambda s: torch.zeros(s, dtype=dtype, device=device)
    return {"ssm": mamba_lm.init_cache(cfg, batch, device=device,
                                       dtype=dtype),
            "attn_k": z(kv), "attn_v": z(kv),
            **{n: z(s) for n, s in T.tails(cfg, g, batch, TAILS).items()}}


def cache_axes(cfg):
    kv = ("layers", "batch", "kv_seq", "act_kv", None)
    tl = ("layers", "batch", None, "act_kv", None)
    return {
        "ssm": mamba_lm.cache_axes(cfg),
        "attn_k": kv, "attn_v": kv,
        "attn_tail_k": tl, "attn_tail_v": tl,
    }


def prefill_out_axes(cfg):
    """The logical axes of prefill's outputs: the logits, the SSM caches
    and the attention applications' K and V."""
    ca = cache_axes(cfg)
    return L.LOGITS_AXES, {n: ca[n] for n in ("ssm", "attn_k", "attn_v")}


def decode_cache(cfg, pre: dict, rules) -> dict:
    """A prefill's cache `pre` and zeroed tails, one row an attention
    application, in the dtype of the context K."""
    g, b = pre["attn_k"].shape[:2]
    return L.with_zeros(pre, T.tails(cfg, g, b, TAILS), pre["attn_k"],
                        cache_axes(cfg), rules)


def decode_step(cfg, params, cache, token, pos: int):
    """One decode step at global position `pos` (>= the context length).
    Returns (logits, new cache)."""
    x = T.decode_embed(params, token)
    positions = torch.full((1,), pos, device=x.device)
    conv, state = cache["ssm"]["conv"], cache["ssm"]["state"]
    tk = cache["attn_tail_k"].clone()
    tv = cache["attn_tail_v"].clone()
    ssm_caches = []
    blocks = T.unstack(params["blocks"])
    for g in range(n_attn_apps(cfg)):
        x, new = mamba_lm.decode_layers(cfg, blocks, x, conv, state,
                                        _group_layers(cfg, g))
        ssm_caches += new
        x, _ = _shared_attn(cfg, params["shared"], x, positions,
                            kv_cache=(cache["attn_k"][g], cache["attn_v"][g],
                                      tk[g], tv[g]), pos=pos)
    x = L.apply_norm(cfg, x, params["final_norm"])
    logits = T.unembed(cfg, params, x)[:, 0, :]
    return logits, dict(cache, ssm=mamba_lm.stack_caches(ssm_caches),
                        attn_tail_k=tk, attn_tail_v=tv)
