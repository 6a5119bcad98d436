"""Shared model building blocks (PyTorch).

Port of ``repro/models/layers.py``. Tensors keep the reference layouts:
activations (b, s, d), heads (b, s, h, hd), stacked weights as in the
reference's param tree. Activations are in the parameters' dtype (bf16
on the card); softmax statistics in fp32. The attention is the
reference's chunked flash attention (a loop over kv blocks with a
running softmax), so a long prefill never holds an S x S score matrix.
Every ParamDef carries the reference's logical axes. Under sharding
rules (``distributed/sharding.py``) params and activations are DTensors
on a ``DeviceMesh``; ``constrain`` sits where the reference's
``with_sharding_constraint`` does and is the identity without rules.
``moe_block`` sends to ``moe_block_sharded`` (the reference's shard_map
dispatch, here explicit collectives on the mesh) when the rules' mesh
has more than one device, and a decode-sized step on the card to the
routed-experts kernel (``kernels/moe_decode``) where ``decode_route``
holds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels.moe_decode import ops as MO

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# ----------------------------------------------------------------------------
# Parameter declaration
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple          # logical axis names, len == len(shape)
    init: str = "normal"  # normal | zeros | ones
    scale: float = 0.02
    dtype: str = "bfloat16"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def _map_defs(fn, defs):
    """fn over the ParamDef leaves of a nested dict, keys sorted."""
    if is_def(defs):
        return fn(defs)
    return {k: _map_defs(fn, defs[k]) for k in sorted(defs)}


def abstract_params(defs):
    """Meta-device tensors of the params' shapes and dtypes (the
    reference's ShapeDtypeStruct tree)."""
    return _map_defs(lambda d: torch.empty(d.shape, dtype=_DTYPES[d.dtype],
                                           device="meta"), defs)


def axes_tree(defs):
    return _map_defs(lambda d: d.axes, defs)


def pspec_tree(defs, rules):
    return _map_defs(lambda d: rules.spec(d.axes, d.shape), defs)


def sharding_tree(defs, rules):
    """Each param's ``Sharding`` (mesh, DTensor placements)."""
    return _map_defs(lambda d: rules.sharding(d.axes, d.shape), defs)


def init_params(defs, generator: torch.Generator, device):
    """Draw a param tree from `defs` (leaves in sorted-key order) with the
    reference's scales: N(0, 1) * scale, zeros or ones."""
    def one(d):
        dt = _DTYPES[d.dtype]
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        if d.init == "normal":
            w = torch.randn(d.shape, generator=generator,
                            dtype=torch.float32, device=device)
            return (w * d.scale).to(dt)
        raise ValueError(d.init)
    return _map_defs(one, defs)


# ----------------------------------------------------------------------------
# Caches
# ----------------------------------------------------------------------------

# the logical axes of prefill's last-position logits
LOGITS_AXES = ("batch", "act_vocab")


def with_zeros(pre: dict, shapes: dict, like, axes: dict, rules):
    """`pre`'s leaves and a zeroed leaf of each ``{name: shape}`` of
    `shapes`, in `like`'s dtype and on its device: DTensors laid out by
    ``axes[name]`` under `rules` when `like` is a DTensor and `rules` is
    not None. A family's ``decode_cache``: the leaves decode writes, beside
    those prefill made."""
    out = dict(pre)
    for name, shape in shapes.items():
        if rules is not None and spmd.is_dtensor(like):
            from torch.distributed.tensor import zeros
            out[name] = zeros(shape, dtype=like.dtype,
                              device_mesh=rules.mesh,
                              placements=rules.placements(axes[name], shape))
        else:
            out[name] = torch.zeros(shape, dtype=like.dtype,
                                    device=like.device)
    return out


def norm_defs(cfg, d: int, prefix_shape=()) -> dict:
    ax = ("layers",) * len(prefix_shape) + ("embed",)
    defs = {"scale": ParamDef(prefix_shape + (d,), ax, init="zeros")}
    if cfg.norm == "layernorm":
        defs["bias"] = ParamDef(prefix_shape + (d,), ax, init="zeros")
    return defs


def attention_defs(cfg, *, stacked: int = 0, cross: bool = False) -> dict:
    """q/k/v/o projections (+ biases). `cross` (an enc-dec decoder's
    cross-attention) declares the same leaves, as in the reference."""
    d, hq, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    pre = (stacked,) if stacked else ()
    pax = ("layers",) if stacked else ()
    defs = {
        "wq": ParamDef(pre + (d, hq, hd),
                       pax + ("embed_fsdp", "heads", "head_dim")),
        "wk": ParamDef(pre + (d, hkv, hd),
                       pax + ("embed_fsdp", "kv_heads", "head_dim")),
        "wv": ParamDef(pre + (d, hkv, hd),
                       pax + ("embed_fsdp", "kv_heads", "head_dim")),
        "wo": ParamDef(pre + (hq, hd, d),
                       pax + ("heads", "head_dim", "embed_fsdp"),
                       scale=0.02 / np.sqrt(2 * max(cfg.num_layers, 1))),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef(pre + (hq, hd), pax + ("heads", "head_dim"),
                              init="zeros")
        defs["bk"] = ParamDef(pre + (hkv, hd),
                              pax + ("kv_heads", "head_dim"), init="zeros")
        defs["bv"] = ParamDef(pre + (hkv, hd),
                              pax + ("kv_heads", "head_dim"), init="zeros")
    return defs


def mlp_defs(cfg, *, stacked: int = 0, d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    pre = (stacked,) if stacked else ()
    pax = ("layers",) if stacked else ()
    defs = {
        "w_up": ParamDef(pre + (d, f), pax + ("embed_fsdp", "mlp")),
        "w_down": ParamDef(pre + (f, d), pax + ("mlp", "embed_fsdp"),
                           scale=0.02 / np.sqrt(2 * max(cfg.num_layers, 1))),
    }
    if cfg.activation in ("swiglu", "geglu"):
        defs["w_gate"] = ParamDef(pre + (d, f), pax + ("embed_fsdp", "mlp"))
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


class _BF16GradBarrier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16)


def bf16_grad_barrier(x):
    """Identity forward; casts the cotangent to bf16.

    Autograd casts the bf16 gradient back to x's dtype, so for an fp32 x
    the gradient stays fp32 but keeps its bf16 rounding; the reference's
    custom VJP returns the bf16 value itself. The values are the same."""
    return _BF16GradBarrier.apply(x)


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
        if sq > 1:
            k = constrain(k, "batch", "seq", "act_heads", None)
            v = constrain(v, "batch", "seq", "act_heads", None)
        else:
            # decode: keep the (possibly seq-sharded) cache layout
            k = constrain(k, "batch", "kv_seq", None, None)
            v = constrain(v, "batch", "kv_seq", None, None)
    if spmd.is_dtensor(q):
        return _flash_attention_sharded(
            q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
            kv_chunk=kv_chunk, scale=scale, return_stats=return_stats)
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


def _flash_attention_sharded(q, k, v, *, q_offset, **kw):
    """flash_attention over DTensors, on each rank's local blocks: batch
    and heads stay where q has them (k and v follow q's head split); a
    seq-sharded q (sequence parallelism) attends over k and v gathered
    on that mesh dim, its causal positions offset by its block's start.
    Where k is seq-sharded on a mesh dim on which q is not split by
    batch or sequence (a decode token over a seq-sharded cache), the
    cache stays where it is: q is gathered there (one token), each rank
    attends over its own kv block and the partials are merged over that
    mesh dim (``_merge_kv_split``). The score and PV matmuls never meet
    DTensor's sharding propagation."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    q_pl, kv_pl, st_pl, split = [], [], [], []
    for i, p in enumerate(q.placements):
        dim = p.dim if p.is_shard() and type(p) is Shard else None
        kp = k.placements[i]
        kv_seq = kp.is_shard() and type(kp) is Shard and kp.dim == 1
        if kv_seq and dim not in (0, 1):   # the cache's own seq split
            if kw["causal"]:
                raise NotImplementedError("causal attention over a "
                                          "seq-sharded kv")
            q_pl.append(Replicate())
            kv_pl.append(kp)
            st_pl.append(Replicate())
            split.append(i)
        elif dim in (0, 2):                 # batch, heads
            q_pl.append(p)
            kv_pl.append(p)
            st_pl.append(Shard({0: 0, 2: 1}[dim]))
        elif dim == 1:                      # sequence parallel
            q_pl.append(p)
            kv_pl.append(Replicate())
            st_pl.append(Shard(2))
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
            st_pl.append(Replicate())
    offset = spmd.block_offset(q.shape, mesh, q_pl)
    if not split:
        def fn(ql, kl, vl):
            return flash_attention(ql, kl, vl, q_offset=q_offset + offset[1],
                                   **kw)
        outs = [q_pl] + ([st_pl, st_pl] if kw["return_stats"] else [])
        return spmd.local(fn, (q, k, v), (q_pl, kv_pl, kv_pl), outs)

    kv_off = spmd.block_offset(k.shape, mesh, kv_pl)[1]
    skv_loc = k.shape[1]
    for i in split:
        skv_loc //= mesh.size(i)
    kv_len = k.shape[1] if kw["kv_len"] is None else kw["kv_len"]
    local_len = min(max(kv_len - kv_off, 0), skv_loc)

    def fn(ql, kl, vl):
        o, m, l = flash_attention(
            ql, kl, vl, q_offset=q_offset + offset[1],
            **dict(kw, kv_len=local_len, return_stats=True))
        return o[None], m[None], l[None]
    lead = lambda pl: [Shard(0) if i in split else
                       (Shard(p.dim + 1) if p.is_shard() else p)
                       for i, p in enumerate(pl)]
    parts = spmd.local(fn, (q, k, v), (q_pl, kv_pl, kv_pl),
                       [lead(q_pl), lead(st_pl), lead(st_pl)])
    o, m, l = _merge_kv_split(*parts, q_pl, st_pl)
    if kw["return_stats"]:
        return o, m, l
    return o


def _merge_kv_split(o, m, l, o_pl, st_pl):
    """Flash partials stacked on a leading dim that is sharded over the
    mesh dims of a kv split -> the merged (out, m, l) laid out by o_pl
    and st_pl, as merge_attention combines them: the max and the
    weighted sums over that dim are reductions (all-reduces) across
    those mesh dims, each done once."""
    mesh = o.device_mesh
    m_star = m.amax(0).redistribute(mesh, st_pl)
    safe = torch.where(torch.isinf(m_star), 0.0, m_star)
    w = l * torch.exp(m - safe[None])                     # (n, b, h, s)
    den = w.sum(0).redistribute(mesh, st_pl)
    num = (w.movedim(2, 3)[..., None] * o.float()).sum(0)
    num = num.redistribute(mesh, o_pl)
    out = num / torch.clamp(den, min=1e-37).movedim(1, 2)[..., None]
    return out.to(o.dtype), m_star, den


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
    q = spmd.einsum("bsd,dhk->bshk", x, p["wq"])
    k = spmd.einsum("bsd,dhk->bshk", x, p["wk"])
    v = spmd.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if use_rope and positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = constrain(q, "batch", "seq", "act_heads", None)
    k = constrain(k, "batch", "seq", "act_kv", None)
    v = constrain(v, "batch", "seq", "act_kv", None)
    return q, k, v


def attention_out(p, o):
    """o: (b, s, hq, hd) -> (b, s, d)."""
    return spmd.einsum("bshk,hkd->bsd", o, p["wo"])


def mlp_block(cfg, p, x):
    act = act_fn(cfg.activation)
    up = spmd.einsum("bsd,df->bsf", x, p["w_up"])
    if "w_gate" in p:
        gate = spmd.einsum("bsd,df->bsf", x, p["w_gate"])
        h = act(gate) * up
    else:
        h = act(up)
    h = constrain(h, "batch", "seq", "act_mlp")
    return spmd.einsum("bsf,fd->bsd", h, p["w_down"])


# ----------------------------------------------------------------------------
# Mixture of Experts (sort-based, dropping, GShard-capacity)
# ----------------------------------------------------------------------------


def moe_defs(cfg, *, stacked: int = 0) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    pre = (stacked,) if stacked else ()
    pax = ("layers",) if stacked else ()
    down_scale = 0.02 / np.sqrt(2 * max(cfg.num_layers, 1))
    return {
        "router": ParamDef(pre + (d, e), pax + ("embed", None)),
        "w_up": ParamDef(pre + (e, d, f),
                         pax + ("experts", "embed_fsdp", "mlp")),
        "w_gate": ParamDef(pre + (e, d, f),
                           pax + ("experts", "embed_fsdp", "mlp")),
        "w_down": ParamDef(pre + (e, f, d),
                           pax + ("experts", "mlp", "embed_fsdp"),
                           scale=down_scale),
    }


def expert_counts(ids, n: int):
    """How many of the int64 `ids` (all < n) name each of n slots:
    ``torch.bincount(ids, minlength=n)``, with a size that does not
    depend on the data (a fake tensor has none), and exact on the card
    (integer adds)."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def moe_capacity(cfg, n_tokens: int) -> int:
    """Slots an expert takes: capacity_factor * t * k / e, rounded up to a
    multiple of 4, at least 4."""
    mo = cfg.moe
    cap = int(np.ceil(mo.capacity_factor * n_tokens * mo.experts_per_token
                      / mo.num_experts))
    return max(4, -(-cap // 4) * 4)


def decode_route(device: str, dtensor: bool, grad: bool, t: int, k: int,
                 e: int, cap: int) -> bool:
    """Whether t tokens routed to k of e experts take the routed-experts
    kernel: on the card (`device` "cuda"), no DTensor, no autograd, and
    nothing the capacity could drop (an expert receives at most t
    assignments, since a token's k experts are distinct, so t <= cap)
    with the routed experts no more than all of them (t * k <= e)."""
    return (device == "cuda" and not dtensor and not grad and t <= cap
            and t * k <= e)


def moe_block(cfg, p, x):
    """x: (b, s, d) -> (y, aux_loss).

    Sends to the two-stage sharded dispatch when a rules context is
    active and its mesh has more than one device, as the reference does;
    a decode-sized step on the card (``decode_route``) to the
    routed-experts kernel, which computes ``moe_block_local``'s function
    from the routed experts alone; otherwise the single-device sort-based
    dispatch."""
    from repro_torch.distributed.sharding import current_rules
    rules = current_rules()
    if rules is not None and rules.n_devices > 1:
        return moe_block_sharded(cfg, p, x, rules)
    ws = (x, p["router"], p["w_gate"], p["w_up"], p["w_down"])
    t = x.numel() // x.shape[-1]
    mo = cfg.moe
    if decode_route(x.device.type, any(spmd.is_dtensor(w) for w in ws),
                    torch.is_grad_enabled()
                    and any(w.requires_grad for w in ws),
                    t, mo.experts_per_token, mo.num_experts,
                    moe_capacity(cfg, t)):
        return MO.moe_decode(x, p["router"], p["w_gate"], p["w_up"],
                             p["w_down"], mo.experts_per_token,
                             cfg.activation)
    return moe_block_local(cfg, p, x)


def moe_gates(cfg, p, xf):
    """Router of (t, d) tokens -> (probs (t, e) fp32, gate values (t, k)
    renormalised, expert ids (t, k)). The logits are rounded to the
    params' dtype before the fp32 softmax, as the reference's einsum
    rounds them; top-k ties go to the lower expert, as lax.top_k's do."""
    k = cfg.moe.experts_per_token
    probs = torch.softmax((xf @ p["router"]).float(), dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[:, :k], gate_idx[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, gate_idx


def moe_dropped(cfg, gate_idx) -> int:
    """Assignments past their expert's capacity: which ones the stable
    sort decides, how many only the per-expert counts."""
    counts = expert_counts(gate_idx.reshape(-1), cfg.moe.num_experts)
    cap = moe_capacity(cfg, gate_idx.shape[0])
    return int((counts - cap).clamp(min=0).sum())


def moe_block_local(cfg, p, x):
    """Single-device sort-based dispatch with capacity.

    Assignments are sorted by expert (stable), and the ones past an
    expert's capacity are dropped. The combine sums each token's k gated
    expert outputs in fp32 in ascending expert order, one add after the
    other: deterministic on the card (no atomics), and the order of the
    reference's scatter-add."""
    mo = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = mo.num_experts, mo.experts_per_token
    xf = x.reshape(t, d)
    dev = x.device
    probs, gate_vals, gate_idx = moe_gates(cfg, p, xf)

    # load-balancing aux loss (Switch-style)
    assign_frac = expert_counts(gate_idx.reshape(-1), e).float() \
        / (t * k)
    aux = e * torch.sum(probs.mean(0) * assign_frac)

    # flatten (t, k) assignments and sort by expert
    tk = t * k
    eids = gate_idx.reshape(tk)
    tok = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(eids, stable=True)
    se, st, sg = eids[order], tok[order], gate_vals.reshape(tk)[order]

    counts = expert_counts(se, e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(tk, device=dev) - starts[se]

    cap = moe_capacity(cfg, t)
    keep = pos < cap
    pos_c = torch.where(keep, pos, cap)        # dropped rows: slot cap

    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=dev)
    buf[se, pos_c] = torch.where(keep[:, None], xf[st], 0)
    buf = buf[:, :cap]

    act = act_fn(cfg.activation)
    up = torch.bmm(buf, p["w_up"])
    gate = torch.bmm(buf, p["w_gate"])
    out = torch.bmm(act(gate) * up, p["w_down"])              # (e, cap, d)

    # the reference gathers slot cap of a cap-long axis for a dropped row
    # (JAX clamps the index); the keep mask zeroes those rows either way
    vals = out[se, pos_c.clamp(max=cap - 1)]
    vals = torch.where(keep[:, None], vals, 0)
    contrib = vals.float() * sg[:, None]                      # (tk, d)
    # a token's assignments lie in the sorted order by ascending expert:
    # gather them back per token in that order and add them in turn
    inv = torch.empty_like(order)
    inv[order] = torch.arange(tk, device=dev)
    slots = inv.reshape(t, k).sort(dim=1).values
    y = torch.zeros((t, d), dtype=torch.float32, device=dev)
    for j in range(k):
        y = y + contrib[slots[:, j]]
    return y.reshape(b, s, d).to(x.dtype), aux


def moe_block_sharded(cfg, p, x, rules):
    """Two-stage MoE dispatch over the rules' mesh (Megatron-EP style),
    the reference's shard_map body on local blocks, with the mesh's
    collectives done by DTensor redistributions (autograd follows them).

    Tokens are sharded over the data axes and replicated over the model
    axis; each rank routes *locally*:
      EP mode (E % model == 0): rank (i, j) keeps only assignments whose
        expert lives in model-column j, compacts them into an
        (E_loc, C_loc, d) buffer, runs its expert slices, scatters
        partial outputs back to local token order; the outputs are summed
        over "model".
      TP mode (E not divisible): every rank processes all local
        assignments against d_ff-sharded expert weights; the down-proj
        contraction is partial over f and the same sum combines it.

    Two weight layouts (rules.table["embed_fsdp"] decides):
      FSDP (training): expert weights sharded on the embed dim over the
        data axes, all-gathered per use (weights travel).
      weight-stationary (decode): weights keep their f-dim shard; the
        *tokens* are all-gathered over the data axes instead, the
        f-partial outputs are summed over data and each rank takes back
        its own token rows (one reduce-scatter of the combined rows; the
        reference sums the expert outputs before the combine).

    The capacity is per local route (the tokens one rank routes), aux is
    each data shard's router loss averaged over data, as in the
    reference. aux is computed alike on every model rank; it enters the
    sum over the model axis from model rank 0 only, so that its gradient
    is counted once.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.distributed.sharding import mesh_axis_names, mesh_shape
    mo = cfg.moe
    mesh = rules.mesh
    names, shape = mesh_axis_names(mesh), mesh_shape(mesh)
    b, s, d = x.shape
    e, k = mo.num_experts, mo.experts_per_token
    data_dims = [i for i, a in enumerate(names) if a in ("pod", "data")]
    model_dim = names.index("model") if "model" in names else None
    n_data = 1
    for i in data_dims:
        n_data *= shape[names[i]]
    msize = shape.get("model", 1)
    ep = e % msize == 0 and msize > 1
    e_loc = e // msize if ep else e
    ws = rules.weight_stationary and bool(data_dims)

    t_route = ((b // n_data) * s) if not ws else b * s
    cap = int(np.ceil(mo.capacity_factor * t_route * k / e))
    cap = max(8, -(-cap // 8) * 8)

    def on(dims, pl, rest):
        return tuple(pl if i in dims else rest[i] for i in range(mesh.ndim))

    rep = (Replicate(),) * mesh.ndim
    everywhere = range(mesh.ndim)
    # layouts of the inputs (the reference's in_specs), and of their
    # gradients: Partial where each rank's local gradient is a part
    x_in = rep if ws else on(data_dims, Shard(0), rep)
    x_grad = on([*data_dims, model_dim] if ws else [model_dim], Partial(),
                x_in)
    w_up_pl = rules.placements(("experts", "embed_fsdp", "mlp"),
                               p["w_up"].shape)
    w_dn_pl = rules.placements(("experts", "mlp", "embed_fsdp"),
                               p["w_down"].shape)
    if ws:
        w_up_in, w_dn_in = w_up_pl, w_dn_pl
        w_up_grad, w_dn_grad = w_up_pl, w_dn_pl
    else:       # FSDP: gathered over the data axes for this use
        w_up_in = on(data_dims, Replicate(), w_up_pl)
        w_dn_in = on(data_dims, Replicate(), w_dn_pl)
        w_up_grad = on(data_dims, Partial(), w_up_pl)
        w_dn_grad = on(data_dims, Partial(), w_dn_pl)

    def local(t, pl, grad_pl):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, rep, run_check=False)
        if tuple(t.placements) != tuple(pl):
            t = t.redistribute(mesh, pl)
        return t.to_local(grad_placements=grad_pl)

    xl = local(x, x_in, x_grad)
    router = local(p["router"], rep, on(everywhere, Partial(), rep))
    w_up = local(p["w_up"], w_up_in, w_up_grad)
    w_gate = local(p["w_gate"], w_up_in, w_up_grad)
    w_down = local(p["w_down"], w_dn_in, w_dn_grad)
    coord = mesh.get_coordinate()
    j = coord[model_dim] if ep else 0
    dev = xl.device

    bl = xl.shape[0]
    xf = xl.reshape(bl * s, d)
    tl = xf.shape[0]
    probs = torch.softmax((xf @ router).float(), dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[:, :k], gate_idx[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    frac = expert_counts(gate_idx.reshape(-1), e).float() \
        / (tl * k)
    aux = e * torch.sum(probs.mean(0) * frac)

    tk = tl * k
    eids = gate_idx.reshape(tk)
    tok = torch.arange(tl, device=dev).repeat_interleave(k)
    gflat = gate_vals.reshape(tk)
    if ep:
        mine = (eids // e_loc) == j
        local_eid = torch.where(mine, eids - j * e_loc, e_loc)
    else:
        mine = torch.ones(tk, dtype=torch.bool, device=dev)
        local_eid = eids
    order = torch.argsort(torch.where(mine, local_eid, e_loc + 1),
                          stable=True)
    se, st, sg = local_eid[order], tok[order], gflat[order]
    valid = se < e_loc

    counts = expert_counts(se, e_loc + 2)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(tk, device=dev) - starts[se]
    keep = valid & (pos < cap)
    pos_c = torch.where(keep, pos, cap)
    se_c = torch.clamp(se, max=e_loc - 1)

    buf = torch.zeros((e_loc, cap + 1, d), dtype=xl.dtype, device=dev)
    buf[se_c, pos_c] = torch.where(keep[:, None], xf[st], 0)
    buf = buf[:, :cap]
    act = act_fn(cfg.activation)
    h = act(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    out = torch.bmm(h, w_down)                                # (e_loc,cap,d)

    vals = out[se_c, pos_c.clamp(max=cap - 1)]
    vals = torch.where(keep[:, None], vals, 0)
    contrib = vals.float() * sg[:, None]
    # each token's kept assignments, ascending expert, one add after the
    # other (moe_block_local's deterministic combine)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(tk, device=dev)
    slots = inv.reshape(tl, k).sort(dim=1).values
    y = torch.zeros((tl, d), dtype=torch.float32, device=dev)
    for i in range(k):
        y = y + contrib[slots[:, i]]
    y = y.reshape(bl, s, d).to(xl.dtype)

    # y: partial over model; over data, sharded rows (FSDP), or every
    # token's rows from each rank's f-shard (weight-stationary: summed
    # over data and each rank takes back its own rows, one
    # reduce-scatter; the reference sums the expert outputs before the
    # combine, which is linear in them)
    y_pl = on([model_dim] + (data_dims if ws else []), Partial(), x_in) \
        if model_dim is not None else on(data_dims if ws else [],
                                          Partial(), x_in)
    y = DTensor.from_local(y, mesh, y_pl, run_check=False).redistribute(
        mesh, on(data_dims, Shard(0), on([model_dim], Replicate(), rep)
                 if model_dim is not None else rep))
    # aux: model rank 0's; each data shard's share of the mean (FSDP) or
    # data rank 0's (weight-stationary: the same tokens everywhere)
    first = model_dim is None or coord[model_dim] == 0
    if ws:
        first = first and all(coord[i] == 0 for i in data_dims)
        aux = aux if first else aux * 0
    else:
        aux = aux / n_data if first else aux * 0
    aux = DTensor.from_local(aux, mesh, (Partial(),) * mesh.ndim,
                             run_check=False).redistribute(mesh, rep)
    return y, aux
