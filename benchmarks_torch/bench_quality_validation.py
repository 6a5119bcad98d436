"""Validates the bits->fidelity curve (QUALITY_OF_BITS) used by the
simulation pipelines against *real* model behaviour: a small LM's context
KV is quantized at each bit width, streamed through the actual
Huffman+dequant path, and greedy decoding is compared token-by-token
against the exact cache.

Port of ``benchmarks/bench_quality_validation.py``: ``SparKVServer`` runs
on the harness's device (``repro_torch.device.resolve``); on the card each
cachegen request assembles every streamed chunk in one ``kv_dequant``
launch (the launches a request are saved as ``kv_dequant_launches``; 0
on the CPU, which takes the plain version). Weights: seeded torch
weights at the reference's scales (``Model.init``); ``measure`` takes any
weights, and the parity tests hand it the reference's, converted.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs import SparKVConfig, get_smoke
from repro_torch.core.baselines import QUALITY_OF_BITS
from repro_torch.device import resolve
from repro_torch.kernels.kv_dequant import kernel as KD
from repro_torch.models import build_model
from repro_torch.serving.engine import SparKVServer

from benchmarks_torch.common import save, table


def smoke_model():
    cfg = get_smoke("sparkv-qwen3-4b", layers=4, d_model=128, heads=8,
                    kv_heads=4, d_ff=256, vocab=1024)
    return cfg, build_model(cfg)


def measure(model, params, device, *, quick: bool):
    """Rows of fidelity a bit width, and the dequant launches of each
    request; `params` on `device`."""
    cfg = model.cfg
    rng = np.random.default_rng(0)
    from repro_torch.data.workloads import lm_token_batch
    ctx = lm_token_batch(rng, cfg.vocab_size, 1, 256)
    rows, launches = [], []
    bit_list = [5, 3] if quick else [8, 5, 4, 3]
    n_req = 2 if quick else 4
    for bits in bit_list:
        spcfg = SparKVConfig(chunk_tokens=64, q_block=32, kv_block=32,
                             quant_bits=bits, quant_group=32)
        srv = SparKVServer(model, params, spcfg, chunk_tokens=64,
                           device=device)
        cid = srv.register_context(ctx)
        agrees, kls = [], []
        for r_i in range(n_req):
            prompt = rng.integers(0, cfg.vocab_size, size=4)
            KD.reset_launches()
            res = srv.generate(cid, prompt, max_new=8, policy="cachegen",
                               seed=r_i)
            launches.append(KD.LAUNCHES["kv_dequant"])
            agrees.append(res.top1_agreement)
            kls.append(res.mean_kl)
        rows.append({
            "bits": bits,
            "measured_top1": float(np.mean(agrees)),
            "measured_kl": float(np.mean(kls)),
            "table_quality": QUALITY_OF_BITS[bits],
        })
    return rows, launches


def run(quick: bool = False):
    _, model = smoke_model()
    dev = resolve()
    rows, launches = measure(model, model.init(0, device=dev), dev,
                             quick=quick)
    print(table(rows, list(rows[0].keys()),
                title="\n[quality validation] real-model fidelity vs the "
                      "bits->quality table used in simulation"))
    print(f"kv_dequant launches a cachegen request: {launches}")
    save("quality_validation", {"rows": rows,
                                "kv_dequant_launches": launches},
         quick=quick)
    return rows


if __name__ == "__main__":
    run()
