"""Training launcher with supervision: run a model config on one device
(the card unless --device names another), checkpoint periodically, and
on (injected or real) failure restart from the last commit.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --smoke --steps 50 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --smoke --steps 30 --inject-fault 12 --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--inject-fault", type=int, default=None,
                    help="simulate a node failure at this step")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import TrainConfig, get_config, get_smoke
    from repro_torch.device import resolve
    from repro_torch.models import build_model
    from repro_torch.training.trainer import FaultInjector, train_loop

    device = resolve(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 10, 1),
                       microbatches=args.microbatches, seed=args.seed,
                       checkpoint_every=args.ckpt_every,
                       checkpoint_dir=args.ckpt_dir)
    cm = CheckpointManager(args.ckpt_dir)
    fault = FaultInjector((args.inject_fault,)) \
        if args.inject_fault is not None else None

    restarts = 0
    while True:
        try:
            out = train_loop(model, tcfg, batch=args.batch, seq=args.seq,
                             steps=args.steps, ckpt_manager=cm, fault=fault,
                             log_every=max(args.steps // 20, 1),
                             device=device)
            break
        except RuntimeError as e:
            restarts += 1
            print(f"[supervisor] failure: {e} — restart {restarts}")
            if restarts > args.max_restarts:
                print("[supervisor] giving up")
                sys.exit(1)

    print(f"\ntrained {args.steps} steps on {device} in "
          f"{out['wall_s']:.1f}s ({restarts} restarts)")
    for step, loss in out["history"]:
        print(f"  step {step:5d}  loss {loss:.4f}")
    first = out["history"][0][1]
    last = out["final_loss"]
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return out


if __name__ == "__main__":
    main()
