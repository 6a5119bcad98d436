"""Pure-SSM LM (mamba2-130m): Mamba2 blocks, no attention (PyTorch).

Port of ``repro/models/mamba_lm.py``; an eager loop over layers takes
the place of the reference's ``lax.scan``, each layer rematerialized
under autograd per cfg.remat. ``decode_step`` returns new conv and
state tensors and leaves the cache it is given untouched, as the
reference does.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.layers import ParamDef


def param_defs(cfg) -> dict:
    n = cfg.num_layers
    return {
        "emb": ParamDef((cfg.padded_vocab, cfg.d_model), ("vocab", "embed")),
        "final_norm": L.norm_defs(cfg, cfg.d_model),
        "blocks": {
            "norm": L.norm_defs(cfg, cfg.d_model, prefix_shape=(n,)),
            "ssm": ssm.ssm_defs(cfg, stacked=n),
        },
    }


def ssm_layer(cfg, bp, x, *, cache=None, return_state=False):
    """Pre-norm residual Mamba2 layer -> (x, layer cache or None)."""
    h = L.apply_norm(cfg, x, bp["norm"])
    y, new_cache = ssm.ssm_block(cfg, bp["ssm"], h, cache=cache,
                                 return_state=return_state)
    return constrain(x + y, "batch", "block_seq", None), new_cache


def stack_caches(caches: list) -> dict:
    """Per-layer {"conv", "state"} -> the (L, ...) stacks."""
    return {k: torch.stack([c[k] for c in caches]) for k in ("conv", "state")}


def forward(cfg, params, tokens, *, collect_state: bool = False):
    """-> (x_final, {"conv": (L, b, cw-1, ch), "state": (L, b, h, p, n)}
    | None)."""
    x = constrain(params["emb"][tokens], "batch", "block_seq", None)
    layer = T._remat(cfg, lambda bp, x: ssm_layer(cfg, bp, x,
                                                  return_state=collect_state))
    caches = []
    for bp in T.unstack(params["blocks"]):
        x, c = layer(bp, x)
        caches.append(c)
    x = L.apply_norm(cfg, x, params["final_norm"])
    return x, stack_caches(caches) if collect_state else None


def loss_fn(cfg, params, batch):
    inp, labels, mask = T.next_token_batch(batch)
    x, _ = forward(cfg, params, inp)
    return T.softmax_xent(cfg, params, x, labels, mask) \
        / torch.clamp(mask.sum(), min=1.0)


def prefill(cfg, params, tokens):
    x, caches = forward(cfg, params, tokens, collect_state=True)
    logits = T.unembed(cfg, params, x[:, -1:, :])[:, 0, :]
    return logits, caches


def init_cache(cfg, batch: int, capacity: int = 0, *, device,
               dtype=torch.bfloat16):
    """conv in `dtype`, state in fp32; the SSM state is O(1) in context
    length, so `capacity` is ignored."""
    del capacity
    d_inner, h, p, n = ssm.ssm_dims(cfg)
    ch = ssm.conv_cache_channels(cfg)
    n_l = cfg.num_layers
    return {
        "conv": torch.zeros((n_l, batch, cfg.ssm.conv_width - 1, ch),
                            dtype=dtype, device=device),
        "state": torch.zeros((n_l, batch, h, p, n), dtype=torch.float32,
                             device=device),
    }


def cache_axes(cfg):
    return {
        "conv": ("layers", "batch", None, None),
        "state": ("layers", "batch", "ssm_heads", "ssm_pdim", "state"),
    }


def decode_layers(cfg, blocks, x, conv, state, layers):
    """Decode the Mamba2 layers `layers` over x (b, 1, d) from the cache
    stacks; `blocks` are the per-layer params (``T.unstack``). Returns x
    and each layer's new (conv, state), cast to the stacks' dtypes."""
    out = []
    for l in layers:
        x, c = ssm_layer(cfg, blocks[l], x,
                         cache={"conv": conv[l], "state": state[l]})
        out.append({"conv": c["conv"].to(conv.dtype),
                    "state": c["state"].to(state.dtype)})
    return x, out


def decode_step(cfg, params, cache, token, pos):
    """One decode step; `pos` is unused (the recurrent state carries the
    position). Returns (logits, new cache)."""
    del pos
    x = T.decode_embed(params, token)
    x, caches = decode_layers(cfg, T.unstack(params["blocks"]), x,
                              cache["conv"], cache["state"],
                              range(cfg.num_layers))
    x = L.apply_norm(cfg, x, params["final_norm"])
    logits = T.unembed(cfg, params, x)[:, 0, :]
    return logits, stack_caches(caches)
