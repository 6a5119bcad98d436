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

from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import constrain
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
    pax = ("layers",) if stacked else ()
    return {
        "wx": ParamDef(pre + (d, h, p),
                       pax + ("embed_fsdp", "ssm_heads", "ssm_pdim")),
        "wz": ParamDef(pre + (d, h, p),
                       pax + ("embed_fsdp", "ssm_heads", "ssm_pdim")),
        "wB": ParamDef(pre + (d, n), pax + ("embed_fsdp", "state")),
        "wC": ParamDef(pre + (d, n), pax + ("embed_fsdp", "state")),
        "wdt": ParamDef(pre + (d, h), pax + ("embed_fsdp", "ssm_heads")),
        "dt_bias": ParamDef(pre + (h,), pax + ("ssm_heads",), init="zeros"),
        "A_log": ParamDef(pre + (h,), pax + ("ssm_heads",), init="zeros"),
        "D": ParamDef(pre + (h,), pax + ("ssm_heads",), init="ones"),
        # depthwise causal conv over x channels (h*p) and B, C (n each)
        "conv_x": ParamDef(pre + (cw, h, p),
                           pax + ("conv", "ssm_heads", "ssm_pdim"),
                           scale=0.5),
        "conv_B": ParamDef(pre + (cw, n), pax + ("conv", "state"),
                           scale=0.5),
        "conv_C": ParamDef(pre + (cw, n), pax + ("conv", "state"),
                           scale=0.5),
        "norm": ParamDef(pre + (h, p), pax + ("ssm_heads", "ssm_pdim"),
                         init="zeros"),
        "wo": ParamDef(pre + (h, p, d),
                       pax + ("ssm_heads", "ssm_pdim", "embed_fsdp"),
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
    [x, B, C], left-padded when s < cw-1. On DTensors (under sharding
    rules) the mixing runs on local blocks (``_mix_sharded``), for the
    train pass, prefill and decode alike."""
    xi = spmd.einsum("bsd,dhp->bshp", x, p["wx"])
    z = spmd.einsum("bsd,dhp->bshp", x, p["wz"])
    Bv = spmd.einsum("bsd,dn->bsn", x, p["wB"])
    Cv = spmd.einsum("bsd,dn->bsn", x, p["wC"])
    dt = spmd.einsum("bsd,dh->bsh", x, p["wdt"]) + p["dt_bias"]
    dt = F.softplus(dt.float())
    A = -torch.exp(p["A_log"].float())

    xi = constrain(xi, "batch", "seq", None, "ssm_pdim")
    mix = {k: p[k] for k in ("conv_x", "conv_B", "conv_C", "D")}
    if spmd.is_dtensor(xi):
        g, new_cache = _mix_sharded(cfg, mix, xi, z, Bv, Cv, dt, A, cache,
                                    return_state)
    else:
        g, new_cache = _mix(cfg, mix, xi, z, Bv, Cv, dt, A, cache,
                            return_state)
    var = torch.mean(g * g, dim=-1, keepdim=True)
    g = g * torch.rsqrt(var + 1e-6)
    g = (g * (1.0 + p["norm"].float())).to(x.dtype)
    out = spmd.einsum("bshp,hpd->bsd", g, p["wo"])
    return out, new_cache


def _mix(cfg, mix, xi, z, Bv, Cv, dt, A, cache, return_state):
    """The block between its projections and its gated norm: causal conv
    (or the decode window), SiLU, the SSD scan (or one recurrence step),
    the D skip and the gate. Returns (g in fp32, new cache or None)."""
    s_cfg = cfg.ssm
    b, s, h, pd = xi.shape           # local blocks under _mix_sharded
    n = Bv.shape[-1]
    xflat = xi.reshape(b, s, h * pd)
    convw = mix["conv_x"].reshape(s_cfg.conv_width, h * pd)
    new_cache = None
    if cache is None:
        xconv = _causal_conv(xflat, convw)
        Bconv = _causal_conv(Bv, mix["conv_B"])
        Cconv = _causal_conv(Cv, mix["conv_C"])
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
        allw = torch.cat([convw, mix["conv_B"], mix["conv_C"]], dim=-1)
        conv_out = torch.sum(win.float() * allw.float()[None], dim=1,
                             keepdim=True).to(xi.dtype)         # (b,1,ch)
        xconv = conv_out[..., :h * pd]
        Bconv = conv_out[..., h * pd:h * pd + n]
        Cconv = conv_out[..., h * pd + n:]
        new_cache = {"conv": win[:, 1:, :]}

    xact = F.silu(xconv.float()).to(xi.dtype).reshape(b, s, h, pd)
    Bact = F.silu(Bconv.float()).to(xi.dtype)
    Cact = F.silu(Cconv.float()).to(xi.dtype)

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
                           xact[:, 0] * dt[:, 0, :, None].to(xi.dtype))
        state = cache["state"] * dA[:, :, None, None] + dBx
        y = torch.einsum("bhpn,bn->bhp", state.to(xi.dtype), Cact[:, 0])
        y = y[:, None]                                         # (b,1,h,p)
        new_cache["state"] = state

    y = y + xact * mix["D"].to(xi.dtype)[None, None, :, None]
    # gated RMSNorm (mamba2 style): norm(y * silu(z))
    g = y.float() * F.silu(z.float())
    return g, new_cache


def _mix_sharded(cfg, mix, xi, z, Bv, Cv, dt, A, cache, return_state):
    """_mix on each rank's local blocks: the batch and the head_dim
    channels (ssm_pdim) stay where xi has them, with the conv weights of
    those channels; a seq-sharded xi is gathered (the scan runs along
    the sequence; a decode token is never seq-sharded). B, C, dt, A and
    D are replicated over the channel split. The gated norm that follows
    reduces over head_dim, so it stays outside, on DTensors.

    The conv cache (b, cw-1, ch) holds the x channels of every head_dim
    split, so a rank reads its own slice of them (and B, C whole) and
    the new window's x channels are gathered over the split (cw-1
    tokens); the state (b, h, p, n) keeps xi's batch and channel
    split."""
    from torch.distributed.tensor import Replicate, Shard
    x_pl, tok_pl, cx_pl, st_pl = [], [], [], []
    for p in xi.placements:
        dim = p.dim if type(p) is Shard else None
        x_pl.append(p if dim in (0, 3) else Replicate())
        tok_pl.append(p if dim == 0 else Replicate())
        cx_pl.append(Shard(2) if dim == 3 else Replicate())
        st_pl.append(Shard(2) if dim == 3 else x_pl[-1])
    rep = [Replicate()] * len(x_pl)
    h, pd = xi.shape[2:]
    mesh = xi.device_mesh
    stateful = cache is not None or return_state

    def fn(xi, z, Bv, Cv, dt, A, cx, cB, cC, D, *old):
        c = None
        if cache is not None:
            conv_x, conv_bc, state = old
            c = {"conv": torch.cat([conv_x.flatten(2), conv_bc], dim=-1),
                 "state": state}
        g, new = _mix(cfg, {"conv_x": cx, "conv_B": cB, "conv_C": cC,
                            "D": D}, xi, z, Bv, Cv, dt, A, c, return_state)
        if not stateful:
            return g
        hp = xi.shape[2] * xi.shape[3]
        win = new["conv"]
        return (g, win[..., :hp].unflatten(2, xi.shape[2:]), win[..., hp:],
                new["state"])

    args = [xi, z, Bv, Cv, dt, A, mix["conv_x"], mix["conv_B"],
            mix["conv_C"], mix["D"]]
    in_pl = [x_pl, x_pl, tok_pl, tok_pl, tok_pl, rep, cx_pl, rep, rep, rep]
    if cache is not None:
        conv = cache["conv"]
        args += [conv[..., :h * pd].unflatten(2, (h, pd)), conv[..., h * pd:],
                 cache["state"]]
        in_pl += [x_pl, tok_pl, st_pl]
    if not stateful:
        return spmd.local(fn, tuple(args), tuple(in_pl), [x_pl]), None
    g, conv_x, conv_bc, state = spmd.local(
        fn, tuple(args), tuple(in_pl), [x_pl, x_pl, tok_pl, st_pl])
    conv_x = conv_x.redistribute(mesh, tok_pl).flatten(2)
    return g, {"conv": torch.cat([conv_x, conv_bc], dim=-1), "state": state}


def conv_cache_channels(cfg) -> int:
    d_inner, h, pd, n = ssm_dims(cfg)
    return h * pd + 2 * n
