"""Granite-4.0-H (``granitemoehybrid``): a stack of Mamba2 and attention
layers, each followed by routed experts and a shared expert, under
Granite's scalar multipliers (ibm-granite/granite-4.0-h-small,
config.json) (PyTorch). The JAX package has no such family.

Layer l is pre-norm twice:

    x = x + residual_multiplier * mixer_l(rmsnorm(x))
    x = x + residual_multiplier * (moe_l(h) + shared_l(h)),  h = rmsnorm(x)

mixer_l is, as ``layer_types[l]`` says, a Mamba2 block (``ssm.ssm_block``:
conv with bias, its gated RMSNorm over the whole group of d_inner
channels) or grouped-query attention without positional encoding at the
softmax scale ``attention_multiplier``. moe_l is ``layers.moe_block`` (a
softmax router over the experts, the top k renormalised), shared_l a
SwiGLU MLP of width ``shared_d_ff`` added with no gate. The embedding is
multiplied by ``embedding_multiplier``, the logits divided by
``logits_scaling``; every RMSNorm takes ``norm_eps``.

A prefill's cache is the context state: ``k``/``v`` of the attention
layers (``kv_layers``), stacked as the transformer's cache is, and each
Mamba layer's ``conv`` window and SSM ``state``. ``decode_step`` writes the
new token's K and V into the tails (``tail_k``/``tail_v``) in place, as
``transformer.decode_step`` does, and returns new conv and state tensors:
the ones it is given are not written.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.layers import ParamDef
from repro_torch.spans import span

KINDS = ("mamba", "attention")


@dataclasses.dataclass(frozen=True)
class GraniteHybridConfig:
    """``base`` (family ``"hybrid_moe"``) holds the widths the family
    shares with the others (d_model, the attention heads, an expert's
    d_ff, vocab, ``moe``, ``ssm``); its attributes read through this
    config. ``layer_types`` gives each layer's mixer, one of ``KINDS``."""
    base: ModelConfig
    layer_types: tuple
    shared_d_ff: int
    embedding_multiplier: float
    attention_multiplier: float
    residual_multiplier: float
    logits_scaling: float
    norm_eps: float = 1e-5

    def __post_init__(self):
        if self.base.family != "hybrid_moe":
            raise ValueError(f"family {self.base.family!r}")
        kinds = set(self.layer_types)
        if kinds != set(KINDS) or len(self.layer_types) != \
                self.base.num_layers:
            raise ValueError(f"{self.base.num_layers} layers need as many "
                             f"layer_types, both of {KINDS}; got "
                             f"{self.layer_types}")
        if self.base.moe is None or self.base.ssm is None:
            raise ValueError("the family needs moe and ssm widths")

    def __getattr__(self, name):
        if name == "base":
            raise AttributeError(name)
        return getattr(self.base, name)


def layers_of(cfg, kind: str) -> list:
    """The layers whose mixer is `kind`, in order."""
    return [l for l, t in enumerate(cfg.layer_types) if t == kind]


def kv_layers(cfg) -> list:
    """The layers that hold K and V: the attention layers, in the order of
    the cache's rows."""
    return layers_of(cfg, "attention")


def plan_config(cfg) -> ModelConfig:
    """What SparKV's planner plans over: the attention layers' rows, each
    a layer of the attention widths and the routed experts (a MoE
    transformer of len(kv_layers) layers); the Mamba layers and the
    shared expert are not in it."""
    return dataclasses.replace(cfg.base, family="moe",
                               num_layers=len(kv_layers(cfg)))


def param_defs(cfg) -> dict:
    n, d = cfg.num_layers, cfg.d_model
    return {
        "emb": ParamDef((cfg.padded_vocab, d), ("vocab", "embed")),
        "final_norm": L.norm_defs(cfg, d),
        "blocks": {
            "mixer_norm": L.norm_defs(cfg, d, prefix_shape=(n,)),
            "ffn_norm": L.norm_defs(cfg, d, prefix_shape=(n,)),
            "moe": L.moe_defs(cfg, stacked=n),
            "shared": L.mlp_defs(cfg, stacked=n, d_ff=cfg.shared_d_ff),
        },
        "mamba": ssm.ssm_defs(cfg, stacked=len(layers_of(cfg, "mamba")),
                              conv_bias=True),
        "attn": L.attention_defs(cfg, stacked=len(kv_layers(cfg))),
    }


def _norm(cfg, x, p):
    return L.rms_norm(x, p["scale"], eps=cfg.norm_eps)


def _mamba(cfg, p, h, **kw):
    return ssm.ssm_block(cfg, p, h, norm_group=ssm.ssm_dims(cfg)[0],
                         norm_eps=cfg.norm_eps, **kw)


def _ffn(cfg, bp, x, *, decode: bool):
    """The second half of a layer: routed experts and the shared expert
    over the normed x, added to x."""
    h = _norm(cfg, x, bp["ffn_norm"])
    with (span("decode.step.ffn") if decode
          else contextlib.nullcontext()):
        y = L.moe_block(cfg, bp["moe"], h)[0] \
            + L.mlp_block(cfg, bp["shared"], h)
    return x + cfg.residual_multiplier * y


def _stacks(cfg, params):
    """Each layer's (kind, its row in its kind's stack, its mixer params,
    its norms and FFN params)."""
    blocks = T.unstack(params["blocks"])
    mixers = {"mamba": T.unstack(params["mamba"]),
              "attention": T.unstack(params["attn"])}
    seen = dict.fromkeys(KINDS, 0)
    out = []
    for l, kind in enumerate(cfg.layer_types):
        j = seen[kind]
        seen[kind] += 1
        out.append((kind, j, mixers[kind][j], blocks[l]))
    return out


def forward(cfg, params, tokens, *, collect: bool = False):
    """Full causal forward. tokens: (b, s) int. Returns (x_final, the
    context state {"k", "v", "conv", "state"} | None)."""
    x = params["emb"][tokens] * cfg.embedding_multiplier
    state = {"k": [], "v": [], "conv": [], "state": []}
    for kind, _, mp, bp in _stacks(cfg, params):
        h = _norm(cfg, x, bp["mixer_norm"])
        if kind == "mamba":
            y, c = _mamba(cfg, mp, h, return_state=collect)
            if collect:
                state["conv"].append(c["conv"])
                state["state"].append(c["state"])
        else:
            q, k, v = L.attention_qkv(cfg, mp, h, use_rope=False)
            o = L.flash_attention(q, k, v, causal=True,
                                  kv_chunk=cfg.attn_chunk,
                                  scale=cfg.attention_multiplier)
            y = L.attention_out(mp, o)
            if collect:
                state["k"].append(k)
                state["v"].append(v)
        x = _ffn(cfg, bp, x + cfg.residual_multiplier * y, decode=False)
    x = _norm(cfg, x, params["final_norm"])
    if not collect:
        return x, None
    return x, {k: torch.stack(v) for k, v in state.items()}


def unembed(cfg, params, x):
    return T.unembed(cfg, params, x) / cfg.logits_scaling


def prefill(cfg, params, tokens):
    """Returns (last-position logits (b, v), the context state: "k"/"v"
    (len(kv_layers), b, s, hkv, hd), "conv" (n_mamba, b, cw-1, ch),
    "state" (n_mamba, b, h, p, n) fp32)."""
    x, state = forward(cfg, params, tokens, collect=True)
    return unembed(cfg, params, x[:, -1:, :])[:, 0, :], state


def init_cache(cfg, batch: int, capacity: int, *, device,
               dtype=torch.bfloat16):
    """capacity = context length (read-only K and V); newly decoded
    tokens' K and V go to the DECODE_TAIL buffers."""
    n_a, n_m = len(kv_layers(cfg)), len(layers_of(cfg, "mamba"))
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    _, h, p, n = ssm.ssm_dims(cfg)
    z = lambda s, dt=dtype: torch.zeros(s, dtype=dt, device=device)
    return {"k": z((n_a, batch, capacity, hkv, hd)),
            "v": z((n_a, batch, capacity, hkv, hd)),
            **{n: z(s) for n, s in
               T.tails(cfg, n_a, batch, T.TAILS).items()},
            "conv": z((n_m, batch, cfg.ssm.conv_width - 1,
                       ssm.conv_cache_channels(cfg))),
            "state": z((n_m, batch, h, p, n), torch.float32)}


def cache_axes(cfg):
    ax = T.cache_axes(cfg)
    return {**ax, "conv": ("layers", "batch", None, None),
            "state": ("layers", "batch", "ssm_heads", "ssm_pdim", "state")}


def prefill_out_axes(cfg):
    """The logical axes of prefill's outputs: the logits and the context
    state."""
    ca = cache_axes(cfg)
    return L.LOGITS_AXES, {n: ca[n] for n in ("k", "v", "conv", "state")}


# prefill's context state and the transformer's tails
decode_cache = T.decode_cache


def decode_step(cfg, params, cache, token, pos: int):
    """One decode step at global position `pos` (>= the context length).
    Writes the new K and V into the cache's tails in place; returns
    (logits, the cache with each Mamba layer's new conv and state)."""
    x = T.decode_embed(params, token) * cfg.embedding_multiplier
    tail_pos = pos - cache["k"].shape[2]
    conv, state = [], []
    for kind, j, mp, bp in _stacks(cfg, params):
        h = _norm(cfg, x, bp["mixer_norm"])
        if kind == "mamba":
            with span("decode.step.ssm"):
                y, c = _mamba(cfg, mp, h, cache={"conv": cache["conv"][j],
                                                 "state": cache["state"][j]})
            conv.append(c["conv"])
            state.append(c["state"])
        else:
            q, k, v = L.attention_qkv(cfg, mp, h, use_rope=False)
            o, _, _ = T.decode_attention(
                cfg, mp, q, k, v, cache["k"][j], cache["v"][j],
                cache["tail_k"][j], cache["tail_v"][j], tail_pos,
                scale=cfg.attention_multiplier)
            y = L.attention_out(mp, o)
        x = _ffn(cfg, bp, x + cfg.residual_multiplier * y, decode=True)
    x = _norm(cfg, x, params["final_norm"])
    logits = unembed(cfg, params, x)[:, 0, :]
    return logits, dict(cache, conv=torch.stack(conv),
                        state=torch.stack(state))
