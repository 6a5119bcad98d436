"""Plain float32 reference of Granite-4.0-H (``granitemoehybrid``): Mamba2
and attention layers, each followed by routed experts and a shared
expert.

It follows the published equations (ibm-granite/granite-4.0-h-small,
config.json) at the widths of the configuration's ``model`` block:

- every layer is pre-norm twice: ``x = x + residual_multiplier *
  mixer(norm(x))``, then ``x = x + residual_multiplier * (moe(h) +
  shared(h))`` with ``h = norm(x)``; RMSNorm is ``x * rsqrt(mean(x^2) +
  norm_eps) * (1 + scale)``;
- a Mamba2 mixer (``layer_types`` "mamba"): projections to x, z, B, C and
  dt; a depthwise causal conv of width ``ssm.conv_width`` with its bias
  over [x, B, C], then SiLU; ``dt = softplus(dt + dt_bias)``, ``A =
  -exp(A_log)``; the per-token recurrence ``h <- exp(dt A) h + dt B (x)``
  and ``y = C . h + D x`` over each head's (head_dim, state_dim) state
  (one group: B and C shared by the heads); the gated RMSNorm ``norm(y *
  silu(z))`` over all d_inner channels at once; the output projection;
- an attention mixer ("attention"): grouped-query attention with no
  positional encoding, scores scaled by ``attention_multiplier``;
- the FFN: a softmax router over ``moe.num_experts``, the top
  ``moe.experts_per_token`` renormalised, SwiGLU experts, none dropped; a
  SwiGLU shared expert of width ``shared_d_ff`` added with no gate;
- the embedding times ``embedding_multiplier``, the tied unembedding's
  logits divided by ``logits_scaling``.

The configuration file's ``departures`` list where the program differs
from the published model. It imports nothing of the program. It reads the
benchmark's weights by the program's leaf names, in float32, a layer's
(an expert's) when it is used, and keeps none, so that the float32 copies
of a large model never sit on the card beside the program's. The check
runs it with TF32 off (``common.plain_fp32``); ``low`` (``common.fp8``)
rounds every matmul operand (projections, attention, router, experts,
unembedding) for the control; the recurrence stays in float32.

A context's state is (k, v, conv, ssm): K and V of the attention layers
(``kv_layers``), each (n_attention, S, hkv, hd); each Mamba layer's last
``mamba_d_conv - 1`` conv inputs [x, B, C], (n_mamba, d_conv - 1,
d_inner + 2 d_state), and its SSM state, (n_mamba, heads, head_dim,
d_state).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

ROW_BLOCK = 256       # query rows a block of the plain attention takes


def kv_layers(m: dict) -> list:
    """The attention layers, in the order of the program's stored rows."""
    return [l for l, t in enumerate(m["layer_types"]) if t == "attention"]


def _mamba_layers(m: dict) -> list:
    return [l for l, t in enumerate(m["layer_types"]) if t == "mamba"]


def _same(t):
    return t


class Reference:
    """The model of one configuration over the benchmark's weights.

    model: the configuration's ``model`` block; params: the weight tree
    (``emb``, ``final_norm``, ``blocks`` stacked over all layers,
    ``mamba`` over the Mamba layers, ``attn`` over the attention layers);
    low: None, or ``fp8`` for the control."""

    def __init__(self, model: dict, params: dict, *, low=None):
        self.m = model
        self.p = params
        self.low = low or _same
        self.eps = model["norm_eps"]
        # each layer's row in the stack of its kind
        self.row = {l: j for rows in (kv_layers(model),
                                      _mamba_layers(model))
                    for j, l in enumerate(rows)}

    # ---- pieces ----
    def _w(self, t):
        return self.low(t.float())

    def _mm(self, x, w):
        return self.low(x) @ w

    def _norm(self, x, scale):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.eps) * (1.0 + scale.float())

    def _swiglu(self, x, gate, up, down):
        return self._mm(F.silu(self._mm(x, self._w(gate)))
                        * self._mm(x, self._w(up)), self._w(down))

    def _mamba(self, j: int, x, conv0, h0):
        """Mamba layer j's mixer over x (T, d) after the conv inputs conv0
        (cw-1, ch) and the state h0 (H, P, N). Returns (out (T, d), conv
        inputs after x, state after x)."""
        p = {k: v[j] for k, v in self.p["mamba"].items()}
        t, d = x.shape
        hh, pp, n = p["wx"].shape[1], p["wx"].shape[2], p["wB"].shape[1]
        di = hh * pp
        xi = self._mm(x, self._w(p["wx"]).reshape(d, di))
        z = self._mm(x, self._w(p["wz"]).reshape(d, di))
        b = self._mm(x, self._w(p["wB"]))
        c = self._mm(x, self._w(p["wC"]))
        dt = F.softplus(self._mm(x, self._w(p["wdt"]))
                        + p["dt_bias"].float())                   # (T, H)
        a = -torch.exp(p["A_log"].float())                        # (H,)
        full = torch.cat([conv0, torch.cat([xi, b, c], -1)])  # (cw-1+T, ch)
        w = torch.cat([p["conv_x"].float().flatten(1), p["conv_B"].float(),
                       p["conv_C"].float()], -1)                  # (cw, ch)
        bias = torch.cat([p["conv_x_bias"].float().flatten(),
                          p["conv_B_bias"].float(), p["conv_C_bias"].float()])
        cw = w.shape[0]
        conv = bias + sum(full[i:i + t] * w[i] for i in range(cw))
        conv = F.silu(conv)
        xs = conv[:, :di].reshape(t, hh, pp)
        bs, cs = conv[:, di:di + n], conv[:, di + n:]
        decay = torch.exp(dt * a)                                 # (T, H)
        dtx = xs * dt[:, :, None]                                 # (T, H, P)
        h = h0.clone()
        y = torch.empty_like(xs)
        for i in range(t):
            h.mul_(decay[i][:, None, None]).addcmul_(
                dtx[i][:, :, None], bs[i][None, None, :])
            torch.matmul(h, cs[i], out=y[i])
        y = y + p["D"].float()[:, None] * xs
        g = y.reshape(t, di) * F.silu(z)
        g = self._norm(g, p["norm"].reshape(di))
        out = self._mm(g, self._w(p["wo"]).reshape(di, d))
        return out, full[full.shape[0] - (cw - 1):], h

    def _attention(self, j: int, x, start: int, ctx):
        """Attention layer j over x (T, d) at positions start.., causal
        over itself and the context (k, v) before it. Returns (out, k, v
        of x)."""
        m, p = self.m, {k: v[j] for k, v in self.p["attn"].items()}
        t, d = x.shape
        hq, hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        q = self._mm(x, self._w(p["wq"]).reshape(d, -1)).reshape(t, hq, hd)
        k = self._mm(x, self._w(p["wk"]).reshape(d, -1)).reshape(t, hkv, hd)
        v = self._mm(x, self._w(p["wv"]).reshape(d, -1)).reshape(t, hkv, hd)
        ka, va = k, v
        if ctx is not None:
            ka, va = torch.cat([ctx[0], k]), torch.cat([ctx[1], v])
        qpos = torch.arange(start, start + t, device=x.device)
        kpos = torch.arange(start + t - ka.shape[0], start + t,
                            device=x.device)
        g = hq // hkv
        o = torch.empty_like(q)
        kl, vl = self.low(ka), self.low(va)
        for r in range(0, t, ROW_BLOCK):
            qb = self.low(q[r:r + ROW_BLOCK]).reshape(-1, hkv, g, hd)
            s = torch.einsum("tkgd,skd->kgts", qb, kl) \
                * m["attention_multiplier"]
            mask = kpos[None, :] <= qpos[r:r + ROW_BLOCK, None]
            pr = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
            o[r:r + ROW_BLOCK] = torch.einsum(
                "kgts,skd->tkgd", self.low(pr), vl).reshape(-1, hq, hd)
        out = self._mm(o.reshape(t, -1), self._w(p["wo"]).reshape(-1, d))
        return out, k, v

    def _moe(self, l: int, x):
        """Layer l's routed experts over x (T, d): the top k of a softmax
        router, renormalised; no token dropped."""
        m, p = self.m, self.p["blocks"]["moe"]
        k = m["moe"]["experts_per_token"]
        probs = torch.softmax(self._mm(x, self._w(p["router"][l])), dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        vals, idx = vals[:, :k], idx[:, :k]
        vals = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
        y = torch.zeros_like(x)
        for ex in idx.unique().tolist():
            rows, slot = (idx == ex).nonzero(as_tuple=True)
            out = self._swiglu(x[rows], p["w_gate"][l][ex], p["w_up"][l][ex],
                               p["w_down"][l][ex])
            y.index_add_(0, rows, out * vals[rows, slot][:, None])
        return y

    def _zero_state(self, x):
        """A Mamba layer's conv inputs and state before the first token."""
        _, hh, pp = self.p["mamba"]["wx"].shape[1:]
        n = self.p["mamba"]["wB"].shape[2]
        return (x.new_zeros((self.m["ssm"]["conv_width"] - 1,
                             hh * pp + 2 * n)),
                x.new_zeros((hh, pp, n)))

    # ---- the model ----
    def run(self, tokens: torch.Tensor, start: int, state=None):
        """The layers over `tokens` (T,) at positions start.. after the
        context state `state` = (k, v, conv, ssm) of the `start` tokens
        before them (None: nothing before). Returns (final-normed x (T,
        d), the state after them, with k and v of `tokens` alone)."""
        m, b = self.m, self.p["blocks"]
        rm = m["residual_multiplier"]
        x = self.p["emb"][tokens].float() * m["embedding_multiplier"]
        ks, vs, convs, hs = [], [], [], []
        for l, kind in enumerate(m["layer_types"]):
            j = self.row[l]
            h = self._norm(x, b["mixer_norm"]["scale"][l])
            if kind == "mamba":
                y, conv, hn = self._mamba(j, h, *(
                    self._zero_state(x) if state is None
                    else (state[2][j], state[3][j])))
                convs.append(conv)
                hs.append(hn)
            else:
                ctx = None if state is None else (state[0][j], state[1][j])
                y, k, v = self._attention(j, h, start, ctx)
                ks.append(k)
                vs.append(v)
            x = x + rm * y
            h = self._norm(x, b["ffn_norm"]["scale"][l])
            sh = b["shared"]
            x = x + rm * (self._moe(l, h)
                          + self._swiglu(h, sh["w_gate"][l], sh["w_up"][l],
                                         sh["w_down"][l]))
        x = self._norm(x, self.p["final_norm"]["scale"])
        return x, (torch.stack(ks), torch.stack(vs), torch.stack(convs),
                   torch.stack(hs))

    def logits(self, x):
        v = self.m["vocab_size"]
        return self._mm(x, self._w(self.p["emb"][:v]).T) \
            / self.m["logits_scaling"]

    def context_kv(self, tokens: torch.Tensor):
        """The state (k, v, conv, ssm) of a context (S,)."""
        return self.run(tokens, 0)[1]

    def decode(self, state, tokens: torch.Tensor):
        """`tokens` fed one after the other after the context state: their
        (T, vocab) logits and the (k, v) they add, each (n_attention, T,
        hkv, hd)."""
        x, (k, v, _, _) = self.run(tokens, state[0].shape[1], state)
        return self.logits(x), k, v


def step_flops(m: dict, kv_len: int) -> int:
    """Model operations of one decode step of one token that attends over
    kv_len keys in each attention layer, 2 per multiply-add: a Mamba
    layer's projections (to x, z, B, C, dt and out) and its state (its
    decay and input, two multiply-adds a state element, and its readout
    by C, one); an attention layer's projections and 4 * head_dim per
    query head and key; every layer's router, its k routed experts and
    the shared expert; the unembedding of vocab_size rows."""
    d, hq, hkv, hd = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                      m["head_dim"])
    s = m["ssm"]
    di, n = s["expand"] * d, s["state_dim"]
    h = di // s["head_dim"]
    mamba = 2 * d * (2 * di + 2 * n + h) + 2 * di * d \
        + 6 * di * n
    attn = 2 * d * (hq + 2 * hkv) * hd + 2 * hq * hd * d \
        + 4 * hq * hd * kv_len
    moe = m["moe"]
    ffn = 2 * d * moe["num_experts"] + 2 * 3 * d * (
        moe["experts_per_token"] * m["d_ff"] + m["shared_d_ff"])
    n_a = len(kv_layers(m))
    n_m = len(m["layer_types"]) - n_a
    return (n_m * mamba + n_a * attn + len(m["layer_types"]) * ffn
            + 2 * d * m["vocab_size"])
