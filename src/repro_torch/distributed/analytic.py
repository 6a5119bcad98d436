"""Analytic per-device HBM-traffic model for the roofline memory term.

Neither HLO source is honest about HBM traffic:
  - the production compile's "bytes accessed" under-counts scanned layers
    (a scan body is costed once), and
  - the calibration compile (inner scans disabled so flops are exact)
    materializes full S x S attention scores the production flash path
    never writes, over-counting bytes 10-50x.
XLA bytes-accessed also ignores fusion: every intermediate is charged.

So the memory term uses a documented analytic model (napkin-roofline
standard), per device, per step:

 train:    W x (fwd read + bwd read)            = 2 Wb
           grads (write + read)                 = 2 Wb
           Adam moments m,v (read + write) + p write
                                                = (4 Wm + 1 Wb)
           layer-boundary activations: save fwd + read bwd + recompute
             writes/reads under full remat      ~ 6 x A
           attention KV streaming through VMEM  ~ 2 x KV
 prefill:  W read + 2 x A + KV write
 decode:   W read + KV cache read + tail r/w (per step)

 W  = param bytes (bf16) / chips  (fully sharded: FSDP x TP)
 Wm = moment bytes / chips
 A  = layers x tokens_local x d_model x 2B   (tokens sharded over data,
      and over model too when inter-block activations are SP-sharded)
 KV = context KV bytes / chips
MoE: all expert weights participate in the capacity-buffer matmuls, so W
is the full (not active) parameter set; activations use d_model.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _dtype_bytes(name: str) -> int:
    return {"bfloat16": 2, "float32": 4, "float16": 2}[name]


def analytic_bytes(cfg: ModelConfig, shape: ShapeConfig,
                   chips: int = 256) -> dict:
    pb = _dtype_bytes(cfg.param_dtype)
    mb = _dtype_bytes(cfg.moment_dtype)
    W = cfg.param_count() * pb / chips
    Wm = cfg.param_count() * mb / chips

    d = cfg.d_model
    tokens_local = shape.global_batch * shape.seq_len / chips
    if cfg.family == "encdec":
        tokens_local = shape.global_batch * (shape.seq_len
                                             + cfg.dec_len) / chips
    layers = cfg.num_layers + cfg.dec_layers
    A = layers * tokens_local * d * 2

    if cfg.num_kv_heads:
        per_layer_kv = (2 * shape.global_batch * shape.seq_len
                        * cfg.num_kv_heads * cfg.resolved_head_dim * 2)
        n_attn = (cfg.num_layers // cfg.attn_every
                  if cfg.family == "hybrid" else layers)
        kv_global = per_layer_kv * n_attn
    else:
        d_inner = cfg.ssm.expand * d
        nheads = d_inner // cfg.ssm.head_dim
        kv_global = (cfg.num_layers * shape.global_batch * nheads
                     * cfg.ssm.head_dim * cfg.ssm.state_dim * 4)
    KV = kv_global / chips

    if shape.kind == "train":
        total = 2 * W + 2 * W + (4 * Wm + W) + 6 * A + 2 * KV
        parts = {"weights": 4 * W, "optimizer": 4 * Wm + W,
                 "activations": 6 * A, "kv": 2 * KV}
    elif shape.kind == "prefill":
        total = W + 2 * A + KV
        parts = {"weights": W, "activations": 2 * A, "kv": KV}
    else:  # decode: one token over the full cache
        A1 = layers * (shape.global_batch / chips) * d * 2
        total = W + KV + 4 * A1
        parts = {"weights": W, "kv_read": KV, "activations": 4 * A1}
    return {"bytes_per_dev": total, "parts": parts}
