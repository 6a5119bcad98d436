"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060] (PyTorch).

Port of ``repro/models/ssm.py``: the chunked SSD algorithm in matmul
form. Intra-chunk outputs come from masked score matmuls; the
inter-chunk recurrence over chunk boundary states, a ``lax.scan`` in the
reference, is a loop over chunks here. The scan is torch operations: the
reference has no Pallas kernel for it.

Projections are separate named weights (x, z, B, C, dt), as in the
reference's param tree. Where the reference rounds an intermediate to
the compute dtype (the intra-chunk matrix M, the weighted inputs, the
states read by the inter-chunk outputs), so does the port.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamDef


def ssm_dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    return d_inner, nheads, s.head_dim, s.state_dim


def ssm_defs(cfg, *, stacked: int = 0) -> dict:
    d = cfg.d_model
    d_inner, h, p, n = ssm_dims(cfg)
    cw = cfg.ssm.conv_width
    pre = (stacked,) if stacked else ()
    return {
        "wx": ParamDef(pre + (d, h, p)),
        "wz": ParamDef(pre + (d, h, p)),
        "wB": ParamDef(pre + (d, n)),
        "wC": ParamDef(pre + (d, n)),
        "wdt": ParamDef(pre + (d, h)),
        "dt_bias": ParamDef(pre + (h,), init="zeros"),
        "A_log": ParamDef(pre + (h,), init="zeros"),
        "D": ParamDef(pre + (h,), init="ones"),
        # depthwise causal conv over x channels (h*p) and B, C (n each)
        "conv_x": ParamDef(pre + (cw, h, p), scale=0.5),
        "conv_B": ParamDef(pre + (cw, n), scale=0.5),
        "conv_C": ParamDef(pre + (cw, n), scale=0.5),
        "norm": ParamDef(pre + (h, p), init="zeros"),
        "wo": ParamDef(pre + (h, p, d),
                       scale=0.02 / np.sqrt(2 * max(cfg.num_layers, 1))),
    }


def _causal_conv(x, w):
    """Depthwise causal conv. x: (b, s, c), w: (cw, c); fp32 sums."""
    cw, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(cw):
        out = out + xp[:, i:i + s].float() * w[i].float()
    return out.to(x.dtype)


def _segsum(dA):
    """Cumulative log-decay matrix: out[..., i, j] = sum_{j<k<=i} dA[..., k].

    dA: (..., cl); returns (..., cl, cl), -inf above the diagonal."""
    cl = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]                 # i row, j col
    ii = torch.arange(cl, device=dA.device)
    mask = ii[:, None] >= ii[None, :]
    return diff.masked_fill(~mask, -torch.inf)


def ssd_chunked(x, dt, A, B, C, *, chunk_len: int,
                init_state: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """Chunked SSD scan.

    x:  (b, s, h, p)   inputs (already conv'd / activated)
    dt: (b, s, h)      positive step sizes
    A:  (h,)           negative decay rates
    B:  (b, s, n), C: (b, s, n)   (one group, shared across heads)
    Returns y: (b, s, h, p) (+ final fp32 state (b, h, p, n) if
    return_state). Products of compute-dtype operands accumulate in fp32.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    cl = min(chunk_len, s)
    nc = -(-s // cl)
    pad = nc * cl - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))

    xc = x.reshape(b, nc, cl, h, p)
    dtc = dt.reshape(b, nc, cl, h).float()
    Bc = B.reshape(b, nc, cl, n)
    Cc = C.reshape(b, nc, cl, n)

    cdt = x.dtype                                              # compute dtype
    dA = dtc * A.float()                                       # (b,nc,cl,h)
    dA_cum = torch.cumsum(dA, dim=2)                           # within chunk

    # ---- intra-chunk (quadratic within cl, matmul form) ----
    scores = torch.einsum("bzin,bzjn->bzij", Cc.float(), Bc.float())
    Ldec = _segsum(dA.movedim(3, 2))                           # (b,nc,h,cl,cl)
    M = scores.to(cdt)[:, :, None] * torch.exp(Ldec).to(cdt)
    M = M * dtc.to(cdt).permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bzhij,bzjhp->bzihp", M.float(), xc.float())

    # ---- chunk boundary states ----
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)   # (b,nc,cl,h)
    xw = xc * (dtc * decay_to_end).to(cdt)[..., None]         # (b,nc,cl,h,p)
    S = torch.einsum("bzjn,bzjhp->bzhpn", Bc.float(), xw.float())

    # ---- inter-chunk recurrence over nc ----
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])               # (b,nc,h)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    before = []
    for z in range(nc):
        before.append(state)
        state = state * chunk_decay[:, z, :, None, None] + S[:, z]
    states_before = torch.stack(before, dim=1)                 # (b,nc,h,p,n)

    # ---- inter-chunk outputs ----
    # y[i,h,p] = exp(dA_cum[i,h]) * sum_n C[i,n] state[h,p,n]
    y_inter = torch.einsum("bzin,bzhpn->bzihp", Cc.float(),
                           states_before.to(cdt).float())
    y_inter = y_inter * torch.exp(dA_cum)[..., None]

    y = (y_intra + y_inter).reshape(b, nc * cl, h, p)[:, :s].to(x.dtype)
    if return_state:
        return y, state
    return y


def ssm_block(cfg, p, x, *, cache=None, return_state=False):
    """Full Mamba2 block: proj -> conv -> SSD -> gated norm -> out proj.

    x: (b, s, d). cache (decode, s == 1): {"conv": (b, cw-1, ch),
    "state": (b, h, p, n)}, read and not written. Returns (y, new cache or
    None); the prefill cache's conv holds the last cw-1 pre-conv inputs
    [x, B, C], left-padded when s < cw-1."""
    s_cfg = cfg.ssm
    d_inner, h, pd, n = ssm_dims(cfg)
    b, s, _ = x.shape

    xi = torch.einsum("bsd,dhp->bshp", x, p["wx"])
    z = torch.einsum("bsd,dhp->bshp", x, p["wz"])
    Bv = torch.einsum("bsd,dn->bsn", x, p["wB"])
    Cv = torch.einsum("bsd,dn->bsn", x, p["wC"])
    dt = torch.einsum("bsd,dh->bsh", x, p["wdt"]) + p["dt_bias"]
    dt = F.softplus(dt.float())
    A = -torch.exp(p["A_log"].float())

    xflat = xi.reshape(b, s, h * pd)
    convw = p["conv_x"].reshape(s_cfg.conv_width, h * pd)
    new_cache = None
    if cache is None:
        xconv = _causal_conv(xflat, convw)
        Bconv = _causal_conv(Bv, p["conv_B"])
        Cconv = _causal_conv(Cv, p["conv_C"])
        if return_state:
            cw = s_cfg.conv_width
            tail = torch.cat([xflat, Bv, Cv], dim=-1)[:, -(cw - 1):, :]
            if s < cw - 1:
                tail = F.pad(tail, (0, 0, cw - 1 - s, 0))
            new_cache = {"conv": tail}
    else:
        # decode: shift the conv window by the new token
        cat = torch.cat([xflat, Bv, Cv], dim=-1)               # (b,1,ch)
        win = torch.cat([cache["conv"], cat], dim=1)           # (b,cw,ch)
        allw = torch.cat([convw, p["conv_B"], p["conv_C"]], dim=-1)
        conv_out = torch.sum(win.float() * allw.float()[None], dim=1,
                             keepdim=True).to(x.dtype)         # (b,1,ch)
        xconv = conv_out[..., :h * pd]
        Bconv = conv_out[..., h * pd:h * pd + n]
        Cconv = conv_out[..., h * pd + n:]
        new_cache = {"conv": win[:, 1:, :]}

    xact = F.silu(xconv.float()).to(x.dtype).reshape(b, s, h, pd)
    Bact = F.silu(Bconv.float()).to(x.dtype)
    Cact = F.silu(Cconv.float()).to(x.dtype)

    if cache is None:
        out = ssd_chunked(xact, dt, A, Bact, Cact,
                          chunk_len=s_cfg.chunk_len,
                          return_state=return_state)
        y, final_state = out if return_state else (out, None)
        if return_state:
            new_cache["state"] = final_state
    else:
        # single-step recurrence: a compute-dtype dBx into the fp32 state
        dA = torch.exp(dt[:, 0, :] * A)                        # (b,h)
        dBx = torch.einsum("bn,bhp->bhpn", Bact[:, 0],
                           xact[:, 0] * dt[:, 0, :, None].to(x.dtype))
        state = cache["state"] * dA[:, :, None, None] + dBx
        y = torch.einsum("bhpn,bn->bhp", state.to(x.dtype), Cact[:, 0])
        y = y[:, None]                                         # (b,1,h,p)
        new_cache["state"] = state

    y = y + xact * p["D"].to(x.dtype)[None, None, :, None]
    # gated RMSNorm (mamba2 style): norm(y * silu(z))
    g = y.float() * F.silu(z.float())
    var = torch.mean(g * g, dim=-1, keepdim=True)
    g = g * torch.rsqrt(var + 1e-6)
    g = (g * (1.0 + p["norm"].float())).to(x.dtype)
    out = torch.einsum("bshp,hpd->bsd", g, p["wo"])
    return out, new_cache


def conv_cache_channels(cfg) -> int:
    d_inner, h, pd, n = ssm_dims(cfg)
    return h * pd + 2 * n
