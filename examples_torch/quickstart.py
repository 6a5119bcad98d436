"""Quickstart: SparKV in ~60 lines, on the PyTorch port.

Builds a small LM, registers a reusable context in the 'cloud' tier,
and serves a request with SparKV hybrid loading — comparing TTFT, energy
and response fidelity against compute-only and stream-only loading. The
streamed chunks of a request are dequantized on the device in one
kv_dequant launch.

  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

Port of ``examples/quickstart.py``: the same model, context, policies and
lines; the weights are drawn from seed 0 on the device (the card unless
``--device cpu``).
"""
import argparse

import numpy as np

from repro_torch.configs import SparKVConfig, get_smoke
from repro_torch.device import resolve
from repro_torch.models import build_model
from repro_torch.serving.engine import SparKVServer

POLICIES = ("sparkv", "local_prefill", "cachegen")


def main(argv=None, *, params=None):
    """Returns {policy: ServeResult}. `params` (a param tree on the
    device) replaces the seeded weights."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card; raises without one) "
                         "or cpu")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    # 1. a small decoder-only LM (same family as the paper's Qwen3-4B)
    cfg = get_smoke("sparkv-qwen3-4b", layers=4, d_model=64, heads=4,
                    d_ff=128, vocab=512)
    model = build_model(cfg)
    if params is None:
        params = model.init(0, device=dev)

    # 2. SparKV configuration: 1024-token chunks in production; small here
    spcfg = SparKVConfig(chunk_tokens=64, q_block=32, kv_block=32,
                         quant_group=32)
    server = SparKVServer(model, params, spcfg, profile="jetson-orin",
                          network="campus-wifi", chunk_tokens=64, device=dev)

    # 3. register a reusable context (cloud precomputes + compresses KV)
    rng = np.random.default_rng(0)
    context = rng.integers(0, cfg.vocab_size, size=(1, 512))
    cid = server.register_context(context)
    stored = server.contexts[cid]
    print(f"context: {context.shape[1]} tokens -> {stored.n_chunks} KV "
          f"chunks, {stored.wl.total_bytes() / 1e6:.2f} MB compressed")

    # 4. serve one request under each loading policy
    prompt = rng.integers(0, cfg.vocab_size, size=4)
    results = {}
    for policy in POLICIES:
        r = server.generate(cid, prompt, max_new=8, policy=policy)
        results[policy] = r
        print(f"{policy:14s} TTFT={r.ttft_s:6.3f}s energy={r.energy_j:7.1f}J "
              f"fidelity={r.top1_agreement:.2f} "
              f"(streamed {r.n_streamed} / computed {r.n_computed} chunks)")
    return results


if __name__ == "__main__":
    main()
