"""Whisper-style encoder-decoder backbone [arXiv:2212.04356] (PyTorch).

Port of ``repro/models/encdec.py``. The conv audio frontend is a stub, as
in the reference: inputs are precomputed frame embeddings (batch, seq,
d_model). The encoder attends bidirectionally without RoPE; the decoder
adds learned positions, attends causally to itself and across to the
encoder output. Eager loops over the stacked layers take the place of
the reference's scans, each layer rematerialized under autograd per
cfg.remat.

Two differences from the reference, both at its edges: ``decode_step``
raises at a position past the self-attention cache (the reference clamps
it onto the last slot), and it returns new self-attention caches and
leaves the ones it is given untouched, as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import ParamDef

# the decoder's self-attention kv chunk (the reference's constant)
SELF_KV_CHUNK = 512


def param_defs(cfg) -> dict:
    ne, nd = cfg.num_layers, cfg.dec_layers
    return {
        "emb": ParamDef((cfg.padded_vocab, cfg.d_model), ("vocab", "embed")),
        "pos_emb": ParamDef((cfg.dec_len, cfg.d_model), (None, "embed")),
        "enc_norm": L.norm_defs(cfg, cfg.d_model),
        "dec_norm": L.norm_defs(cfg, cfg.d_model),
        "enc": {
            "attn_norm": L.norm_defs(cfg, cfg.d_model, prefix_shape=(ne,)),
            "mlp_norm": L.norm_defs(cfg, cfg.d_model, prefix_shape=(ne,)),
            "attn": L.attention_defs(cfg, stacked=ne),
            "mlp": L.mlp_defs(cfg, stacked=ne),
        },
        "dec": {
            "self_norm": L.norm_defs(cfg, cfg.d_model, prefix_shape=(nd,)),
            "cross_norm": L.norm_defs(cfg, cfg.d_model, prefix_shape=(nd,)),
            "mlp_norm": L.norm_defs(cfg, cfg.d_model, prefix_shape=(nd,)),
            "self_attn": L.attention_defs(cfg, stacked=nd),
            "cross_attn": L.attention_defs(cfg, stacked=nd, cross=True),
            "mlp": L.mlp_defs(cfg, stacked=nd),
        },
    }


def _enc_block(cfg, bp, x):
    h = L.apply_norm(cfg, x, bp["attn_norm"])
    q, k, v = L.attention_qkv(cfg, bp["attn"], h, None, use_rope=False)
    o = L.flash_attention(q, k, v, causal=False, kv_chunk=cfg.attn_chunk)
    x = constrain(x + L.attention_out(bp["attn"], o),
                  "batch", "block_seq", None)
    h = L.apply_norm(cfg, x, bp["mlp_norm"])
    return constrain(x + L.mlp_block(cfg, bp["mlp"], h),
                     "batch", "block_seq", None)


def encode(cfg, params, frames):
    """frames: (b, s, d) -> encoder output (b, s, d)."""
    x = constrain(frames, "batch", "block_seq", None)
    block = T._remat(cfg, lambda bp, x: _enc_block(cfg, bp, x))
    for bp in T.unstack(params["enc"]):
        x = block(bp, x)
    return L.apply_norm(cfg, x, params["enc_norm"])


def _cross_kv(cfg, params, enc_out):
    """Each decoder layer's cross-attention K/V of the encoder output (the
    whisper analogue of the SparKV streamable artifact).
    Returns (k, v): (nd, b, s_enc, hkv, hd)."""
    ks, vs = [], []
    for bp in T.unstack(params["dec"]):
        p = bp["cross_attn"]
        k = spmd.einsum("bsd,dhk->bshk", enc_out, p["wk"])
        v = spmd.einsum("bsd,dhk->bshk", enc_out, p["wv"])
        if cfg.qkv_bias:
            k = k + p["bk"]
            v = v + p["bv"]
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def _dec_block(cfg, bp, x, cross_kv, *, self_cache=None, pos=None):
    """One decoder layer. Teacher-forced (self_cache None): causal
    self-attention over x, returns (x, (k, v)). Decode: self_cache =
    (k, v) of (b, dec_len, hkv, hd), written IN PLACE at pos (at the last
    slot past it, as the reference's ``dynamic_update_slice`` clamps;
    kv_len pos + 1 then attends every slot); returns (x, self_cache)."""
    h = L.apply_norm(cfg, x, bp["self_norm"])
    q, k, v = L.attention_qkv(cfg, bp["self_attn"], h, None, use_rope=False)
    if self_cache is None:
        o = L.flash_attention(q, k, v, causal=True, kv_chunk=SELF_KV_CHUNK)
        new_kv = (k, v)
    else:
        ck, cv = self_cache
        slot = min(pos, ck.shape[1] - 1)
        spmd.write(ck, slot, k[:, 0])
        spmd.write(cv, slot, v[:, 0])
        o = L.flash_attention(q, ck, cv, causal=False, kv_len=pos + 1,
                              kv_chunk=SELF_KV_CHUNK)
        new_kv = (ck, cv)
    x = x + L.attention_out(bp["self_attn"], o)

    # cross-attention to the encoder output
    h = L.apply_norm(cfg, x, bp["cross_norm"])
    q = spmd.einsum("bsd,dhk->bshk", h, bp["cross_attn"]["wq"])
    if cfg.qkv_bias:
        q = q + bp["cross_attn"]["bq"]
    ek, ev = cross_kv
    o = L.flash_attention(q, ek, ev, causal=False, kv_chunk=cfg.attn_chunk)
    x = x + L.attention_out(bp["cross_attn"], o)

    h = L.apply_norm(cfg, x, bp["mlp_norm"])
    return x + L.mlp_block(cfg, bp["mlp"], h), new_kv


def decode_train(cfg, params, enc_out, dec_tokens):
    """Teacher-forced decoder. dec_tokens: (b, t) -> (b, t, d), post-norm."""
    t = dec_tokens.shape[1]
    # not a reference site: a vocab-sharded gather is a masked partial
    # sum, which the layer norm's mean cannot take (GSPMD reduces it
    # implicitly)
    x = constrain(params["emb"][dec_tokens], "batch", "block_seq", None)
    x = x + params["pos_emb"][None, :t, :].to(x.dtype)
    ck, cv = _cross_kv(cfg, params, enc_out)
    block = T._remat(cfg, lambda bp, x, ek, ev: _dec_block(
        cfg, bp, x, (ek, ev))[0])
    for l, bp in enumerate(T.unstack(params["dec"])):
        x = block(bp, x, ck[l], cv[l])
    return L.apply_norm(cfg, x, params["dec_norm"])


def loss_fn(cfg, params, batch):
    """batch: {"frames": (b, s, d), "dec_tokens": (b, t+1)} -> mean xent."""
    dec = batch["dec_tokens"]
    inp, labels = dec[:, :-1], dec[:, 1:]
    mask = (labels >= 0).float()
    labels = labels.clamp(min=0)
    enc_out = encode(cfg, params, batch["frames"])
    x = decode_train(cfg, params, enc_out, inp)
    tot = T.softmax_xent(cfg, params, x, labels, mask,
                         chunk=min(cfg.loss_chunk, 128))
    return tot / torch.clamp(mask.sum(), min=1.0)


def prefill(cfg, params, frames):
    """Encoder pass + cross-KV construction (the streamable KV artifact)."""
    ck, cv = _cross_kv(cfg, params, encode(cfg, params, frames))
    return {"cross_k": ck, "cross_v": cv}


def self_caches(cfg, rows: int, batch: int) -> dict:
    """The leaves decode writes, ``{name: shape}``: the decoder's
    self-attention K and V, dec_len slots in each of `rows` layers."""
    return dict.fromkeys(("self_k", "self_v"), (
        rows, batch, cfg.dec_len, cfg.num_kv_heads, cfg.resolved_head_dim))


def init_cache(cfg, batch: int, enc_len: int, *, device,
               dtype=torch.bfloat16):
    nd, hkv, hd = cfg.dec_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    z = lambda s: torch.zeros(s, dtype=dtype, device=device)
    return {
        "cross_k": z((nd, batch, enc_len, hkv, hd)),
        "cross_v": z((nd, batch, enc_len, hkv, hd)),
        **{n: z(s) for n, s in self_caches(cfg, nd, batch).items()},
    }


def cache_axes(cfg):
    kv = ("layers", "batch", "kv_seq", "act_kv", None)
    sf = ("layers", "batch", None, "act_kv", None)
    return {"cross_k": kv, "cross_v": kv, "self_k": sf, "self_v": sf}


def prefill_out_axes(cfg):
    """The logical axes of prefill's outputs: the cross-attention K and V
    (no logits)."""
    ca = cache_axes(cfg)
    return {"cross_k": ca["cross_k"], "cross_v": ca["cross_v"]}


def decode_cache(cfg, pre: dict, rules) -> dict:
    """A prefill's cross K and V and zeroed self-attention caches, in the
    dtype of the cross K."""
    nd, b = pre["cross_k"].shape[:2]
    return L.with_zeros(pre, self_caches(cfg, nd, b), pre["cross_k"],
                        cache_axes(cfg), rules)


def decode_step(cfg, params, cache, token, pos: int):
    """One decoder token at position `pos` >= 0; the cross-KV comes from
    the cache. At pos >= dec_len it answers as the reference, whose
    dynamic slices clamp: the last learned position, the last self-cache
    slot, every slot attended. Returns (logits, new cache): the self
    caches are copied before the new token is written, so `cache` stays
    as it was. A negative pos raises."""
    if pos < 0:
        raise ValueError(f"decode position {pos} is before the "
                         f"{cfg.dec_len}-token decoder cache")
    x = T.decode_embed(params, token)
    p = min(pos, cfg.dec_len - 1)
    x = x + params["pos_emb"][None, p:p + 1].to(x.dtype)
    sk, sv = cache["self_k"].clone(), cache["self_v"].clone()
    for l, bp in enumerate(T.unstack(params["dec"])):
        x, _ = _dec_block(cfg, bp, x, (cache["cross_k"][l],
                                       cache["cross_v"][l]),
                          self_cache=(sk[l], sv[l]), pos=pos)
    x = L.apply_norm(cfg, x, params["dec_norm"])
    logits = T.unembed(cfg, params, x)[:, 0, :]
    return logits, dict(cache, self_k=sk, self_v=sv)
