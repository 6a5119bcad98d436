"""Oracle for the routed experts of a decode-sized MoE step: each token,
each routed expert, one at a time, at the eager dispatch's rounding
points (``models/layers.py::moe_block_local`` with nothing dropped)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def moe_decode_ref(x, router, w_gate, w_up, w_down, k: int,
                   activation: str = "swiglu"):
    """x: (t, d) -> (y (t, d) in x's dtype, aux loss)."""
    act = F.silu if activation in ("swiglu", "silu") else (
        lambda v: F.gelu(v, approximate="tanh"))
    t, d = x.shape
    e = router.shape[1]
    probs = torch.softmax((x @ router).float(), dim=-1)
    y = torch.zeros((t, d), dtype=torch.float32)
    counts = torch.zeros(e)
    for i in range(t):
        order = sorted(range(e), key=lambda j: (-float(probs[i, j]), j))[:k]
        total = max(sum(float(probs[i, j]) for j in order), 1e-9)
        counts[order] += 1
        for j in sorted(order):
            h = act(x[i] @ w_gate[j]) * (x[i] @ w_up[j])
            y[i] += (h @ w_down[j]).float() * (float(probs[i, j]) / total)
    aux = e * torch.sum(probs.mean(0) * counts / (t * k))
    return y.to(x.dtype), aux
