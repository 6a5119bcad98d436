"""Plain float32 reference of the decoder-only transformer, dense and MoE.

It follows the architecture that a configuration file under
``cardbench/configs`` states in its ``model`` block (pre-norm blocks,
RMSNorm applied as ``x * rsqrt(mean(x^2) + 1e-6) * (1 + scale)``, rotary
embedding by half rotation, grouped-query attention at ``head_dim ** -0.5``,
SwiGLU MLP or top-k routed SwiGLU experts with renormalised gates, tied or
separate unembedding). The file's ``departures`` list where that
architecture differs from the published model.

It imports nothing of the program. It reads the weights the benchmark made
(the same tensors the program is given) by leaf name, in float32, one
layer at a time; the check runs it with TF32 off (``common.plain_fp32``).
``low`` makes it the control (``common.fp8``: every matmul operand rounded
to float8 e4m3 with a per-tensor scale, the precision below the bfloat16
the configurations state).

Every layer holds K and V (``kv_layers``), so a context's state is its
(k, v) alone. ``step_flops`` counts the model operations of one decode
step.
"""
from __future__ import annotations

import math

import torch

ROW_BLOCK = 256       # query rows a block of the plain attention takes


def kv_layers(m: dict) -> list:
    """The layers that hold K and V, in the order of the program's stored
    rows: all of them."""
    return list(range(m["num_layers"]))


def _same(t):
    return t


class Reference:
    """The model of one configuration over the benchmark's weights.

    model: the configuration's ``model`` block; params: the weight tree
    (``emb``, ``final_norm``, ``blocks`` stacked by layer, ``unemb`` when
    not tied); low: None, or ``fp8`` for the control."""

    def __init__(self, model: dict, params: dict, *, low=None):
        self.m = model
        self.p = params
        self.low = low or _same
        self._layers: dict = {}
        self._emb = None
        moe = model.get("moe")
        self.moe = dict(moe) if moe else None

    # ---- weights, float32 (rounded once for the control) ----
    def _w(self, t):
        return self.low(t.float())

    def layer(self, l: int) -> dict:
        if l not in self._layers:
            b = self.p["blocks"]
            w = {"attn_norm": b["attn_norm"]["scale"][l].float(),
                 "mlp_norm": b["mlp_norm"]["scale"][l].float()}
            for k in ("wq", "wk", "wv", "wo"):
                w[k] = self._w(b["attn"][k][l])
            ff = b["moe"] if self.moe else b["mlp"]
            for k in ff:
                w[k] = self._w(ff[k][l])
            self._layers[l] = w
        return self._layers[l]

    def unembedding(self) -> torch.Tensor:
        """(d, vocab) float32: the embedding's first vocab rows,
        transposed, when tied."""
        if self._emb is None:
            v = self.m["vocab_size"]
            if self.m["tie_embeddings"]:
                self._emb = self._w(self.p["emb"][:v]).T
            else:
                self._emb = self._w(self.p["unemb"][:, :v])
        return self._emb

    # ---- pieces ----
    def _mm(self, x, w):
        return self.low(x) @ w

    @staticmethod
    def _norm(x, scale):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) \
            * (1.0 + scale)

    def _rope(self, x, pos):
        """x: (T, h, hd); pos: (T,) int."""
        half = x.shape[-1] // 2
        inv = self.m["rope_theta"] ** (
            -torch.arange(half, dtype=torch.float64, device=x.device) / half)
        ang = pos.to(torch.float64)[:, None] * inv[None, :]
        cos = torch.cos(ang).float()[:, None, :]
        sin = torch.sin(ang).float()[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def _attend(self, q, k, v, qpos, kpos):
        """Causal GQA attention. q: (T, hq, hd); k, v: (S, hkv, hd)."""
        t, hq, hd = q.shape
        hkv = k.shape[1]
        g = hq // hkv
        out = torch.empty_like(q)
        kl, vl = self.low(k), self.low(v)
        for r in range(0, t, ROW_BLOCK):
            qb = self.low(q[r:r + ROW_BLOCK]).reshape(-1, hkv, g, hd)
            s = torch.einsum("tkgd,skd->kgts", qb, kl) * hd ** -0.5
            mask = kpos[None, :] <= qpos[r:r + ROW_BLOCK, None]
            s = s.masked_fill(~mask, -math.inf)
            p = torch.softmax(s, dim=-1)
            o = torch.einsum("kgts,skd->tkgd", self.low(p), vl)
            out[r:r + ROW_BLOCK] = o.reshape(-1, hq, hd)
        return out

    def _mlp(self, w, x):
        h = torch.nn.functional.silu(self._mm(x, w["w_gate"])) \
            * self._mm(x, w["w_up"])
        return self._mm(h, w["w_down"])

    def _moe(self, w, x, capacity: bool):
        """Top-k routed SwiGLU experts with renormalised gates. With
        `capacity`, an expert takes at most its capacity of the (token,
        choice) assignments in token order and drops the rest, as a batch
        of len(x) tokens is routed; without, none is dropped (a decode
        step routes one token, under every expert's capacity)."""
        mo = self.moe
        e, k = mo["num_experts"], mo["experts_per_token"]
        t = x.shape[0]
        probs = torch.softmax(self._mm(x, w["router"]), dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        vals, idx = vals[:, :k], idx[:, :k]
        vals = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
        keep = torch.ones_like(idx, dtype=torch.bool)
        if capacity:
            cap = math.ceil(mo["capacity_factor"] * t * k / e)
            cap = max(4, -(-cap // 4) * 4)
            onehot = torch.nn.functional.one_hot(idx.reshape(-1), e)
            rank = (onehot.cumsum(0) * onehot).sum(-1) - 1
            keep = (rank < cap).reshape(t, k)
        y = torch.zeros_like(x)
        for ex in range(e):
            sel = (idx == ex) & keep
            rows, slot = sel.nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = x[rows]
            h = torch.nn.functional.silu(self._mm(xe, w["w_gate"][ex])) \
                * self._mm(xe, w["w_up"][ex])
            y.index_add_(0, rows, self._mm(h, w["w_down"][ex])
                         * vals[rows, slot][:, None])
        return y

    # ---- the model ----
    def run(self, tokens: torch.Tensor, start: int, ctx=None, *,
            capacity: bool):
        """The blocks over `tokens` (T,) at positions start.., attending
        causally to themselves and to the context `ctx` = (k, v), each
        (L, start, hkv, hd), before them. Returns (final-normed x (T, d),
        [(k, v) of each layer's own tokens])."""
        m = self.m
        hq, hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        dev = tokens.device
        x = self.p["emb"][tokens].float()
        t = x.shape[0]
        qpos = torch.arange(start, start + t, device=dev)
        kv = []
        for l in range(m["num_layers"]):
            w = self.layer(l)
            h = self._norm(x, w["attn_norm"])
            q = self._mm(h, w["wq"].reshape(m["d_model"], -1)).reshape(
                t, hq, hd)
            k = self._mm(h, w["wk"].reshape(m["d_model"], -1)).reshape(
                t, hkv, hd)
            v = self._mm(h, w["wv"].reshape(m["d_model"], -1)).reshape(
                t, hkv, hd)
            q, k = self._rope(q, qpos), self._rope(k, qpos)
            kv.append((k, v))
            if ctx is not None:
                k = torch.cat([ctx[0][l], k])
                v = torch.cat([ctx[1][l], v])
            kpos = torch.arange(start + t - k.shape[0], start + t,
                                device=dev)
            o = self._attend(q, k, v, qpos, kpos)
            x = x + self._mm(o.reshape(t, -1), w["wo"].reshape(-1,
                                                               m["d_model"]))
            h = self._norm(x, w["mlp_norm"])
            x = x + (self._moe(w, h, capacity) if self.moe
                     else self._mlp(w, h))
        x = self._norm(x, self.p["final_norm"]["scale"].float())
        return x, kv

    def context_kv(self, tokens: torch.Tensor):
        """The state of a context (S,): (k, v), each (L, S, hkv, hd),
        keys after the rotary embedding; the context is routed as one
        batch."""
        _, kv = self.run(tokens, 0, capacity=True)
        return (torch.stack([k for k, _ in kv]),
                torch.stack([v for _, v in kv]))

    def decode(self, ctx, tokens: torch.Tensor):
        """`tokens` fed one after the other after the context cache
        `ctx`, each step routed alone: their (T, vocab) logits and the
        (k, v) they add to the cache, each (L, T, hkv, hd)."""
        x, kv = self.run(tokens, ctx[0].shape[1], ctx, capacity=False)
        return (self._mm(x, self.unembedding()),
                torch.stack([k for k, _ in kv]),
                torch.stack([v for _, v in kv]))


def step_flops(m: dict, kv_len: int) -> int:
    """Model operations of one decode step of one token that attends over
    kv_len keys: 2 per multiply-add of every weight matrix the token
    touches (attention projections; the MLP, or the router and its k
    routed experts; the unembedding of vocab_size rows), and 4 * head_dim
    per query head and key for the attention."""
    d, hq, hkv, hd = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                      m["head_dim"])
    attn = 2 * d * hq * hd + 2 * d * hkv * hd
    moe = m.get("moe")
    if moe:
        ffn = d * moe["num_experts"] \
            + moe["experts_per_token"] * 3 * d * m["d_ff"]
    else:
        ffn = 3 * d * m["d_ff"]
    layers = m["num_layers"]
    return (2 * layers * (attn + ffn) + 4 * layers * hq * hd * kv_len
            + 2 * d * m["vocab_size"])
