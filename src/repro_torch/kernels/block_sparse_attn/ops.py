"""Sparse prefill attention: block importance -> block lists -> the
block-sparse kernels (PyTorch port of
``repro/kernels/block_sparse_attn/ops.py``).

`sparse_prefill_attention` is the paper's sparse local-compute attention:
score blocks with pooled q/k, keep each row's blocks up to `mass`
(``sparse/mask.py``), then attend over the kept blocks. The kernel call
dispatches on the tensors' device: a CUDA kernel on the card (with the
kv heads unrepeated and ``kv_group = hq / hkv``; inputs in another
layout than contiguous and 16-byte aligned are copied first and counted
in ``COPIES``), the plain version on the CPU, an error anywhere else.
``use_ref=True`` takes the dense oracle of ``ref.py``. The reference's
``interpret`` argument chose the Pallas interpreter and has no
counterpart here.
"""
from __future__ import annotations

from repro_torch.kernels._layout import dense
from repro_torch.kernels.block_sparse_attn import kernel as K
from repro_torch.kernels.block_sparse_attn.ref import \
    block_sparse_attention_ref
from repro_torch.sparse.mask import block_scores, select_blocks

# inputs copied into the kernels' layout (contiguous, 16-byte aligned)
COPIES = {"block_sparse_attention": 0}


def block_sparse_attention(q, k, v, block_idx, block_cnt, **kw):
    """Same contract as ``kernel.block_sparse_attention_plain``, for q, k,
    v and the lists in any layout."""
    if q.device.type == "cuda":
        q, k, v, block_idx, block_cnt = (
            dense(t, COPIES, "block_sparse_attention")
            for t in (q, k, v, block_idx, block_cnt))
        return K.block_sparse_attention(q, k, v, block_idx, block_cnt, **kw)
    if q.device.type == "cpu":
        return K.block_sparse_attention_plain(q, k, v, block_idx, block_cnt,
                                              **kw)
    raise ValueError(f"no block_sparse_attention for device {q.device}")


def heads_first(x):
    """(b, s, h, d) -> contiguous (b*h, s, d)."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).contiguous().view(b * h, s, d)


def block_lists(qf, kf, g: int, *, mass: float, q_block: int,
                kv_block: int, causal: bool):
    """(block_idx, block_cnt) of flattened q (b*hq, s, d) against
    unrepeated kf (b*hkv, s, d): each q row scored against its kv head."""
    kf_rep = kf.repeat_interleave(g, dim=0) if g > 1 else kf
    scores = block_scores(qf, kf_rep, q_block=q_block, kv_block=kv_block,
                          causal=causal)
    return select_blocks(scores, mass=mass, q_block=q_block,
                         kv_block=kv_block)


def sparse_prefill_attention(q, k, v, *, mass: float = 0.98,
                             q_block: int = 128, kv_block: int = 128,
                             causal: bool = True, use_ref: bool = False):
    """q: (b, s, hq, d); k/v: (b, s, hkv, d). Returns ((b, s, hq, d),
    block_cnt (b, hq, s // q_block)): the per-row active-block counts feed
    the latency predictor's `s` feature."""
    b, s, hq, d = q.shape
    g = hq // k.shape[2]
    qf, kf, vf = heads_first(q), heads_first(k), heads_first(v)
    idx, cnt = block_lists(qf, kf, g, mass=mass, q_block=q_block,
                           kv_block=kv_block, causal=causal)
    if use_ref:
        o = block_sparse_attention_ref(
            qf, kf.repeat_interleave(g, dim=0),
            vf.repeat_interleave(g, dim=0), idx, cnt, causal=causal,
            q_block=q_block, kv_block=kv_block)
    else:
        o = block_sparse_attention(qf, kf, vf, idx, cnt, causal=causal,
                                   q_block=q_block, kv_block=kv_block,
                                   kv_group=g)
    o = o.view(b, hq, s, d).transpose(1, 2)
    return o, cnt.view(b, hq, s // q_block)
