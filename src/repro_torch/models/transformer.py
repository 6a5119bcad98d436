"""Decoder-only transformer LM, dense and MoE families (PyTorch).

Port of ``repro/models/transformer.py``. The reference scans stacked
layer params with ``lax.scan``; here an eager loop takes the layers of
each stacked tensor (``unstack``), and ``_remat`` checkpoints each layer
under autograd as the reference's ``jax.checkpoint`` does.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels.decode_attn import ops as DO
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamDef
from repro_torch.spans import span

# capacity of the decode tail buffer (newly generated tokens); the
# context cache stays read-only, as in the reference
DECODE_TAIL = 128
# the decode cache's leaves of the newly decoded tokens' K and V
TAILS = ("tail_k", "tail_v")

# decode attentions that took the eager path (flash_attention over the
# context and the tail, then merge_attention); the kernel's launches are
# kernels.decode_attn.kernel.LAUNCHES
EAGER_CALLS = {"decode_attention": 0}


def param_defs(cfg) -> dict:
    n = cfg.num_layers
    defs = {
        "emb": ParamDef((cfg.padded_vocab, cfg.d_model), ("vocab", "embed")),
        "final_norm": L.norm_defs(cfg, cfg.d_model),
        "blocks": {
            "attn_norm": L.norm_defs(cfg, cfg.d_model, prefix_shape=(n,)),
            "mlp_norm": L.norm_defs(cfg, cfg.d_model, prefix_shape=(n,)),
            "attn": L.attention_defs(cfg, stacked=n),
        },
    }
    if cfg.moe is not None:
        defs["blocks"]["moe"] = L.moe_defs(cfg, stacked=n)
    else:
        defs["blocks"]["mlp"] = L.mlp_defs(cfg, stacked=n)
    if not cfg.tie_embeddings:
        defs["unemb"] = ParamDef((cfg.d_model, cfg.padded_vocab),
                                 ("embed_fsdp", "vocab"))
    return defs


def unstack(blocks: dict) -> list:
    """Every layer of a stacked param subtree, one ``torch.unbind`` a
    leaf (``spmd.unbind`` on a DTensor): its backward stacks the layers'
    grads in one allocation, where taking layer l with ``v[l]`` builds a
    zero tensor the size of the whole leaf in each layer's backward."""
    cols = {k: unstack(v) if isinstance(v, dict) else spmd.unbind(v)
            for k, v in blocks.items()}
    n = len(next(iter(cols.values())))
    return [{k: c[l] for k, c in cols.items()} for l in range(n)]


# "dots": keep the outputs of matmuls without batch dims (the reference's
# dots_with_no_batch_dims_saveable), recompute everything else
_save_dots = functools.partial(
    create_selective_checkpoint_contexts,
    [torch.ops.aten.mm.default, torch.ops.aten.addmm.default])


def _remat(cfg, fn):
    """fn rematerialized per cfg.remat under autograd: "full" recomputes
    it in the backward pass, "dots" keeps its matmul outputs and
    recomputes the rest, "none" keeps every activation. Without grad
    (prefill, decode) it is fn."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat {cfg.remat!r}")
    context_fn = _save_dots if cfg.remat == "dots" else noop_context_fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=context_fn)
    return run


def _kernel_path(q, ctx_k, tail_k) -> bool:
    """Whether decode attention takes the flash-decode kernel: CUDA
    tensors that are not DTensors. The kernel's launcher refuses, with an
    error, a dtype or head shape it cannot take."""
    return q.device.type == "cuda" and not any(
        spmd.is_dtensor(t) for t in (q, ctx_k, tail_k))


def decode_attention(cfg, bp_attn, q, k, v, ctx_k, ctx_v, tail_k, tail_v,
                     tail_pos: int, scale=None):
    """Attend a single new token over [static context] + [tail buffer],
    its scores scaled by `scale` (default head_dim ** -0.5).

    ctx_*: (b, cap, hkv, hd) read-only, possibly seq-sharded;
    tail_*: (b, DECODE_TAIL, hkv, hd). The new (k, v) is written at
    tail_pos IN PLACE (the reference returns updated copies), on each
    rank's own block of a DTensor tail. Past the buffer, as the
    reference's ``dynamic_update_slice`` clamps, it is written into the
    last slot, and every slot is attended (kv_len tail_pos + 1 covers
    them all). A negative tail_pos raises. Returns (o, tail_k, tail_v).

    On the card (CUDA tensors that are not DTensors) the token attends
    over the context and the tail's first tail_pos + 1 slots as two key
    segments of one flash-decode launch
    (``kernels.decode_attn.ops.decode_attention``; scores and softmax in
    fp32, p rounded to v's dtype before P V), neither copied; a dtype or
    head shape the kernels cannot take raises there. Elsewhere
    (the CPU, DTensors) it runs the reference's eager path: flash
    attention over the context, then over the tail, merged; counted in
    ``EAGER_CALLS``."""
    if tail_pos < 0:
        raise ValueError(f"decode position {tail_pos} is before the tail "
                         "buffer")
    slot = min(tail_pos, tail_k.shape[1] - 1)
    with span("decode.step.attention"):
        spmd.write(tail_k, slot, k[:, 0])
        spmd.write(tail_v, slot, v[:, 0])
        if _kernel_path(q, ctx_k, tail_k):
            # one token's q, dense for the kernel (a copy only where the
            # projection left another layout)
            o = DO.decode_attention(
                q[:, 0].contiguous(), ctx_k, ctx_v, ctx_k.shape[1],
                k2=tail_k, v2=tail_v,
                kv_len2=min(tail_pos + 1, tail_k.shape[1]), scale=scale)
            return o[:, None], tail_k, tail_v
        EAGER_CALLS["decode_attention"] += 1
        p1 = L.flash_attention(q, ctx_k, ctx_v, causal=False,
                               kv_chunk=max(cfg.attn_chunk, 2048),
                               scale=scale, return_stats=True)
        p2 = L.flash_attention(q, tail_k, tail_v, causal=False,
                               kv_len=tail_pos + 1, kv_chunk=DECODE_TAIL,
                               scale=scale, return_stats=True)
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
    y = constrain(L.attention_out(bp["attn"], o),
                  "batch", "block_seq", None)
    x = constrain(x + y, "batch", "block_seq", None)
    h = L.apply_norm(cfg, x, bp["mlp_norm"])
    with (span("decode.step.ffn") if kv_cache is not None
          else contextlib.nullcontext()):
        y, aux = (L.moe_block(cfg, bp["moe"], h) if cfg.moe is not None
                  else (L.mlp_block(cfg, bp["mlp"], h), 0.0))
    y = constrain(y, "batch", "block_seq", None)
    x = constrain(x + y, "batch", "block_seq", None)
    return L.bf16_grad_barrier(x), new_kv, aux


def forward(cfg, params, tokens, *, collect_kv: bool = False):
    """Full causal forward. tokens: (b, s) int.

    Returns (x_final, (k_stack, v_stack) | None, aux_sum); the stacks are
    (L, b, s, hkv, hd). x_final is post-final-norm; aux_sum is the MoE
    router loss summed over layers (0.0 for the dense family)."""
    x = constrain(params["emb"][tokens], "batch", "block_seq", None)
    positions = torch.arange(tokens.shape[1], device=x.device)
    ks, vs = [], []
    aux = 0.0
    block = _remat(cfg, functools.partial(_block, cfg))
    for bp in unstack(params["blocks"]):
        x, (k, v), a = block(bp, x, positions)
        aux = aux + a
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = L.apply_norm(cfg, x, params["final_norm"])
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return x, kvs, aux


def unembed(cfg, params, x):
    w = params["emb"].T if cfg.tie_embeddings else params["unemb"]
    return constrain(spmd.einsum("bsd,dv->bsv", x, w),
                     "batch", "seq", "act_vocab")


def _xent_sum(cfg, params, x, labels, mask):
    logits = unembed(cfg, params, x).float()
    lse = torch.logsumexp(logits, dim=-1)
    # the label logits keep their gathered (.., 1) shape into the
    # subtraction: on a vocab-sharded DTensor the pick is a partial sum,
    # reduced there
    lab = spmd.take_label(logits, labels)
    return torch.sum((lse[..., None] - lab)[..., 0] * mask)


def softmax_xent(cfg, params, x, labels, mask, *, chunk: int = 0):
    """Cross-entropy summed over the masked positions, unembedding
    `chunk` positions at a time (O(chunk * V) memory). Under autograd
    each chunk is checkpointed, as in the reference: its fp32 logits are
    recomputed in the backward pass, not kept."""
    chunk = chunk or cfg.loss_chunk
    part = (functools.partial(checkpoint, _xent_sum, use_reentrant=False)
            if torch.is_grad_enabled() else _xent_sum)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[1], chunk):
        sl = slice(i, i + chunk)
        tot = tot + part(cfg, params, x[:, sl], labels[:, sl], mask[:, sl])
    return tot


def next_token_batch(batch):
    """{"tokens": (b, s+1)} -> (inputs, labels, mask); labels < 0 are
    masked out."""
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    return inp, labels.clamp(min=0), (labels >= 0).float()


def loss_fn(cfg, params, batch):
    """batch: {"tokens": (b, s+1)} -> scalar mean xent (+ MoE aux)."""
    inp, labels, mask = next_token_batch(batch)
    x, _, aux = forward(cfg, params, inp)
    loss = softmax_xent(cfg, params, x, labels, mask) \
        / torch.clamp(mask.sum(), min=1.0)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_coef * aux / cfg.num_layers
    return loss


def prefill(cfg, params, tokens):
    """Returns (last-position logits (b, v), kv cache stack (L,b,s,hkv,hd) x2)."""
    x, kvs, _ = forward(cfg, params, tokens, collect_kv=True)
    logits = unembed(cfg, params, x[:, -1:, :])[:, 0, :]
    return logits, {"k": kvs[0], "v": kvs[1]}


def tails(cfg, rows: int, batch: int, names: tuple) -> dict:
    """The leaves decode writes, ``{name: shape}`` for each of `names`:
    the K and V of the newly decoded tokens, DECODE_TAIL slots in each of
    `rows` (one a KV layer; a hybrid's, one an application of its shared
    block)."""
    return dict.fromkeys(names, (rows, batch, DECODE_TAIL, cfg.num_kv_heads,
                                 cfg.resolved_head_dim))


def init_cache(cfg, batch: int, capacity: int, *, device,
               dtype=torch.bfloat16):
    """capacity = context length (read-only); newly decoded tokens live in
    the DECODE_TAIL buffer."""
    shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    z = lambda s: torch.zeros(s, dtype=dtype, device=device)
    return {"k": z(shape), "v": z(shape),
            **{n: z(s) for n, s in
               tails(cfg, cfg.num_layers, batch, TAILS).items()}}


def cache_axes(cfg):
    ax = ("layers", "batch", "kv_seq", "act_kv", None)
    tl = ("layers", "batch", None, "act_kv", None)
    return {"k": ax, "v": ax, "tail_k": tl, "tail_v": tl}


def prefill_out_axes(cfg):
    """The logical axes of prefill's outputs: the logits, K and V."""
    ca = cache_axes(cfg)
    return L.LOGITS_AXES, {"k": ca["k"], "v": ca["v"]}


def decode_cache(cfg, pre: dict, rules) -> dict:
    """A prefill's cache `pre` (``k``, ``v`` and whatever else the family
    keeps) and zeroed tails, in the dtype of the context K."""
    rows, b = pre["k"].shape[:2]
    return L.with_zeros(pre, tails(cfg, rows, b, TAILS), pre["k"],
                        cache_axes(cfg), rules)


def kv_layers(cfg) -> list:
    """The layers that hold K and V: every one."""
    return list(range(cfg.num_layers))


def plan_config(cfg):
    """What SparKV's planner plans over: the model itself."""
    return cfg


def decode_embed(params, token):
    """The embedding of one token a row, (b, 1, d). Not a reference site:
    on a vocab-sharded table the lookup is a masked partial sum
    (``spmd.embed``; GSPMD partitions its gather so), reduced here once,
    so that the weight-stationary decode moves no weight; the plain
    lookup without rules."""
    return constrain(spmd.embed(params["emb"], token[:, None]), "batch",
                     "block_seq", None)


def decode_step(cfg, params, cache, token, pos: int):
    """One decode step. token: (b,) int; pos: global position
    (pos >= context capacity; the new token goes to the tail buffer).
    Updates cache's tail buffers in place and returns (logits, cache)."""
    x = decode_embed(params, token)                            # (b, 1, d)
    positions = torch.full((1,), pos, device=x.device)
    for l, bp in enumerate(unstack(params["blocks"])):
        x, _, _ = _block(cfg, bp, x, positions,
                         kv_cache=(cache["k"][l], cache["v"][l],
                                   cache["tail_k"][l], cache["tail_v"][l]),
                         pos=pos)
    x = L.apply_norm(cfg, x, params["final_norm"])
    logits = unembed(cfg, params, x)[:, 0, :]
    return logits, cache
