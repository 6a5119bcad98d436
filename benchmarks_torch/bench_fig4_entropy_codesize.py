"""Fig. 4/5: entropy and Huffman code-size distribution of real KV chunks
— a small model's actual KV cache is quantized to 5 bits and entropy
coded; per-(layer, head) entropy spread drives compressed-size spread.

Port of ``benchmarks/bench_fig4_entropy_codesize.py``: the prefill runs
on the harness's device (``repro_torch.device.resolve``), on seeded torch
weights at the reference's scales (``Model.init``; the reference draws
them with ``jax.random``, so the two harnesses' numbers differ by their
weights). ``measure`` takes any weights: the parity tests hand it the
reference's, converted.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.compression import huffman
from repro_torch.compression.quantize import quantize
from repro_torch.configs import get_smoke
from repro_torch.device import resolve
from repro_torch.models import build_model

from benchmarks_torch.common import save, table


def smoke_model():
    cfg = get_smoke("sparkv-qwen3-4b", layers=4, d_model=128, heads=8,
                    kv_heads=4, vocab=512)
    return cfg, build_model(cfg)


def measure(model, params, device):
    """Rows, per-chunk entropies and sizes of one prefill's KV cache;
    `params` on `device`."""
    cfg = model.cfg
    rng = np.random.default_rng(0)
    # highly repetitive context (context-reuse workloads are): V vectors of
    # repeated tokens are identical -> low-entropy chunks; K carries RoPE
    # position structure -> higher entropy. Both measured, like the paper.
    from repro_torch.data.workloads import lm_token_batch
    toks = lm_token_batch(rng, cfg.vocab_size, 1, 512, motif_len=128,
                          n_motifs=4)
    with torch.no_grad():
        _, cache = model.prefill(params,
                                 {"tokens": torch.from_numpy(toks).to(device)})
    k = cache["k"].float().cpu().numpy()      # (L, 1, S, hkv, hd)
    v = cache["v"].float().cpu().numpy()

    ents, sizes = [], []
    for tensor in (k, v):
        for l in range(cfg.num_layers):
            for h in range(cfg.num_kv_heads):
                vals = tensor[l, 0, :, h, :]
                qt = quantize(vals, 5, 64)
                e = huffman.entropy_bits(qt.codes, 32)
                enc = huffman.encode(qt.codes, 32, n_streams=32)
                ents.append(e)
                sizes.append(enc.payload_bytes() + qt.header_bytes())
    ents, sizes = np.array(ents), np.array(sizes)
    raw = vals.size * 5 / 8
    rows = [{
        "chunks": len(ents),
        "entropy_min_b": float(ents.min()),
        "entropy_p50_b": float(np.median(ents)),
        "entropy_max_b": float(ents.max()),
        "size_min_KB": float(sizes.min() / 1e3),
        "size_max_KB": float(sizes.max() / 1e3),
        "size_spread_x": float(sizes.max() / sizes.min()),
        "vs_raw5bit": float(np.mean(sizes) / (raw + 16)),
    }]
    return rows, ents, sizes


def run(quick: bool = False):
    _, model = smoke_model()
    dev = resolve()
    rows, ents, sizes = measure(model, model.init(0, device=dev), dev)
    print(table(rows, list(rows[0].keys()),
                title="\n[Fig 4/5] KV chunk entropy & Huffman code size "
                      "(real model KV)"))
    save("fig4_entropy_codesize", {"rows": rows,
                                   "entropies": ents.tolist(),
                                   "sizes": sizes.tolist()},
         quick=quick)
    return rows


if __name__ == "__main__":
    run()
