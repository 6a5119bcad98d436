"""The plain reference against a second plain computation at a tiny size:
a token-by-token float64 loop with explicit heads and experts."""
import math

import numpy as np
import pytest
import torch

from cardbench.reference import common as Q
from cardbench.reference.common import fp8
from cardbench.reference.transformer import Reference

D, HQ, HKV, HD, F, V, L = 32, 4, 2, 8, 48, 96, 2


def _model(moe=None):
    m = {"family": "moe" if moe else "dense", "num_layers": L,
         "d_model": D, "num_heads": HQ, "num_kv_heads": HKV, "head_dim": HD,
         "d_ff": F, "vocab_size": V, "rope_theta": 10000.0,
         "tie_embeddings": True}
    if moe:
        m["moe"] = moe
    return m


def _params(m, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: (torch.randn(*s, generator=g) * 0.3).to(torch.bfloat16)
    blocks = {"attn_norm": {"scale": r(L, D)},
              "mlp_norm": {"scale": r(L, D)},
              "attn": {"wq": r(L, D, HQ, HD), "wk": r(L, D, HKV, HD),
                       "wv": r(L, D, HKV, HD), "wo": r(L, HQ, HD, D)}}
    if m.get("moe"):
        e = m["moe"]["num_experts"]
        blocks["moe"] = {"router": r(L, D, e), "w_up": r(L, e, D, F),
                         "w_gate": r(L, e, D, F), "w_down": r(L, e, F, D)}
    else:
        blocks["mlp"] = {"w_up": r(L, D, F), "w_gate": r(L, D, F),
                         "w_down": r(L, F, D)}
    return {"emb": r(V + 32, D), "final_norm": {"scale": r(D)},
            "blocks": blocks}


def _naive(m, p, tokens):
    """Every position's logits and every layer's (k, v), one token after
    the other, float64, no capacity."""
    f = lambda t: t.double()
    b = p["blocks"]
    theta = m["rope_theta"]

    def norm(x, s):
        return x / math.sqrt(float((x * x).mean()) + 1e-6) * (1 + f(s))

    def rope(x, pos):
        half = HD // 2
        out = x.clone()
        for i in range(half):
            a = pos * theta ** (-i / half)
            c, s = math.cos(a), math.sin(a)
            out[..., i] = x[..., i] * c - x[..., i + half] * s
            out[..., i + half] = x[..., i] * s + x[..., i + half] * c
        return out

    silu = lambda x: x / (1 + torch.exp(-x))
    ks = [[] for _ in range(L)]
    vs = [[] for _ in range(L)]
    logits = []
    for pos, tok in enumerate(tokens):
        x = f(p["emb"][tok])
        for l in range(L):
            h = norm(x, b["attn_norm"]["scale"][l])
            q = torch.einsum("d,dhk->hk", h, f(b["attn"]["wq"][l]))
            k = torch.einsum("d,dhk->hk", h, f(b["attn"]["wk"][l]))
            v = torch.einsum("d,dhk->hk", h, f(b["attn"]["wv"][l]))
            q, k = rope(q, pos), rope(k, pos)
            ks[l].append(k)
            vs[l].append(v)
            o = torch.zeros(HQ, HD, dtype=torch.float64)
            for hh in range(HQ):
                kv = hh // (HQ // HKV)
                sc = torch.stack([q[hh] @ kk[kv] for kk in ks[l]]) \
                    / math.sqrt(HD)
                w = torch.softmax(sc, 0)
                o[hh] = sum(wi * vv[kv] for wi, vv in zip(w, vs[l]))
            x = x + torch.einsum("hk,hkd->d", o, f(b["attn"]["wo"][l]))
            h = norm(x, b["mlp_norm"]["scale"][l])
            if m.get("moe"):
                mo = b["moe"]
                pr = torch.softmax(h @ f(mo["router"][l]), 0)
                top = sorted(range(len(pr)), key=lambda i: -float(pr[i]))
                top = top[:m["moe"]["experts_per_token"]]
                tot = sum(float(pr[i]) for i in top)
                y = 0
                for e in top:
                    a = silu(h @ f(mo["w_gate"][l][e])) \
                        * (h @ f(mo["w_up"][l][e]))
                    y = y + float(pr[e]) / tot * (a @ f(mo["w_down"][l][e]))
            else:
                mp = b["mlp"]
                a = silu(h @ f(mp["w_gate"][l])) * (h @ f(mp["w_up"][l]))
                y = a @ f(mp["w_down"][l])
            x = x + y
        x = norm(x, p["final_norm"]["scale"])
        logits.append(x @ f(p["emb"][:V]).T)
    return (torch.stack(logits),
            torch.stack([torch.stack(k) for k in ks]),
            torch.stack([torch.stack(v) for v in vs]))


@pytest.mark.parametrize("moe", [None, {"num_experts": 6,
                                        "experts_per_token": 2,
                                        "capacity_factor": 100.0}])
def test_reference_against_a_token_loop(moe):
    m = _model(moe)
    p = _params(m)
    tokens = torch.tensor([3, 17, 5, 88, 40, 2, 61, 9, 30, 71])
    ctx_len = 6
    want_logits, want_k, want_v = _naive(m, p, tokens.tolist())
    ref = Reference(m, p)
    k, v = ref.context_kv(tokens[:ctx_len])
    torch.testing.assert_close(k.double(), want_k[:, :ctx_len],
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(v.double(), want_v[:, :ctx_len],
                               rtol=1e-4, atol=1e-5)
    got, dk, dv = ref.decode((k, v), tokens[ctx_len:])
    torch.testing.assert_close(got.double(), want_logits[ctx_len:],
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dk.double(), want_k[:, ctx_len:],
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dv.double(), want_v[:, ctx_len:],
                               rtol=1e-4, atol=1e-5)


def test_capacity_drops_the_later_assignments():
    """With a capacity of 4 a layer's prefill of 12 tokens drops, for an
    expert chosen more than 4 times, its later (token, choice) pairs, in
    token order: the reference's output then differs from the dropless
    one at those tokens only."""
    moe = {"num_experts": 2, "experts_per_token": 1, "capacity_factor": 0.1}
    m = _model(moe)
    p = _params(m, seed=3)
    ref = Reference(m, p)
    w = ref.layer(0)
    x = torch.randn(12, D, generator=torch.Generator().manual_seed(1))
    dropped = ref._moe(w, x, capacity=True)
    full = ref._moe(w, x, capacity=False)
    choice = (x @ w["router"]).argmax(-1)
    rank = torch.zeros(12, dtype=torch.long)
    for e in range(2):
        idx = (choice == e).nonzero().reshape(-1)
        rank[idx] = torch.arange(len(idx))
    kept = rank < 4
    assert (~kept).any() and kept.any()
    torch.testing.assert_close(dropped[kept], full[kept])
    assert (dropped[~kept] == 0).all()


def test_quantizer_matches_the_scheme():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 64, generator=g) * 3
    codes, step, lo = Q.quantize(x, 5, 64)
    xs = x.numpy().astype(np.float32)
    want_lo = xs.min(1)
    want_step = np.maximum(xs.max(1) - want_lo, np.float32(1e-8)) \
        / np.float32(31)
    want = np.clip(np.round((xs - want_lo[:, None]) / want_step[:, None]),
                   0, 31)
    assert np.array_equal(codes.numpy(), want)
    assert np.array_equal(step.numpy(), want_step.astype(np.float32))
    back = Q.dequantize(codes, step, lo)
    assert float(((back - x.double()).abs()
                  / step.double()[:, None]).max()) <= 0.5 + 1e-5
    assert Q.roundtrip(x, 4, 64).shape == x.shape


def test_fp8_control_is_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    e8 = float((fp8(x) - x).norm() / x.norm())
    e16 = float((x.bfloat16().float() - x).norm() / x.norm())
    assert 4 * e16 < e8 < 0.1
