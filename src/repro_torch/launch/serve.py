"""Serving launcher (PyTorch port): spin up a SparKVServer on a reduced
config, register a reusable context, and serve requests under each
loading policy, reporting TTFT / energy / response-fidelity.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch sparkv-qwen3-4b \
      --requests 4 --context-chunks 6 --policies sparkv,local_prefill

Runs on the CUDA card; ``--device cpu`` runs on the CPU instead.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="sparkv-qwen3-4b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--context-chunks", type=int, default=6)
    ap.add_argument("--chunk-tokens", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--policies",
                    default="sparkv,strong_hybrid,cachegen,local_prefill")
    ap.add_argument("--profile", default="jetson-orin")
    ap.add_argument("--network", default="campus-wifi")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    from repro_torch.configs import SparKVConfig, get_smoke
    from repro_torch.device import resolve
    from repro_torch.models import build_model
    from repro_torch.serving.engine import SparKVServer

    device = resolve(args.device)
    cfg = get_smoke(args.arch, layers=4, d_model=64, heads=4, d_ff=128,
                    vocab=512)
    model = build_model(cfg)
    params = model.init(args.seed, device=device)
    spcfg = SparKVConfig(chunk_tokens=args.chunk_tokens,
                         q_block=min(32, args.chunk_tokens),
                         kv_block=min(32, args.chunk_tokens),
                         quant_group=32)
    srv = SparKVServer(model, params, spcfg, profile=args.profile,
                       network=args.network,
                       chunk_tokens=args.chunk_tokens, seed=args.seed,
                       device=device)

    rng = np.random.default_rng(args.seed)
    ctx = rng.integers(0, cfg.vocab_size,
                       size=(1, args.context_chunks * args.chunk_tokens))
    cid = srv.register_context(ctx)
    print(f"registered context {cid} on {device}: {ctx.shape[1]} tokens, "
          f"{srv.contexts[cid].n_chunks} chunks, "
          f"{srv.contexts[cid].wl.total_bytes() / 1e6:.2f} MB compressed")

    for policy in args.policies.split(","):
        ttfts, agrees, kls, energies = [], [], [], []
        for r in range(args.requests):
            prompt = rng.integers(0, cfg.vocab_size, size=4)
            res = srv.generate(cid, prompt, max_new=args.max_new,
                               policy=policy, seed=args.seed + r)
            ttfts.append(res.ttft_s)
            agrees.append(res.top1_agreement)
            kls.append(res.mean_kl)
            energies.append(res.energy_j)
        print(f"{policy:14s} TTFT={np.mean(ttfts):7.3f}s  "
              f"energy={np.mean(energies):8.1f}J  "
              f"top1-fidelity={np.mean(agrees):.3f}  "
              f"KL={np.mean(kls):.4f}")


if __name__ == "__main__":
    main()
