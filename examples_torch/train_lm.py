"""Example: end-to-end training script on the PyTorch port — train a
~100M-param dense LM for a few hundred steps with checkpointing and a
mid-run injected failure (supervisor restarts from the last commit; loss
curve is continuous).

  PYTHONPATH=src python examples_torch/train_lm.py [--steps 200]
      [--fail-at 120] [--device cpu]

Port of ``examples/train_lm.py``: the same flags, model, schedule and
supervisor, on ``repro_torch.training.trainer.train_loop`` (the card
unless ``--device cpu``), checkpointing into a directory of its own
under the temporary directory (``$TMPDIR``, else ``/tmp``).
"""
import argparse
import dataclasses
import os
import shutil
import tempfile

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import TrainConfig, get_config
from repro_torch.device import resolve
from repro_torch.models import build_model
from repro_torch.training.trainer import FaultInjector, train_loop

CKPT_DIR = os.path.join(tempfile.gettempdir(),
                        "repro_torch_train_lm_example")


def main(argv=None, *, cfg=None, tcfg=None, ckpt_dir=CKPT_DIR):
    """Returns train_loop's result of the run that finished, with the
    supervisor's `restarts`. `cfg` and `tcfg` replace the ~100M model and
    its schedule (smaller runs), `ckpt_dir` the checkpoint directory."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a node failure at this step")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card; raises without one) "
                         "or cpu")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    if cfg is None:
        # ~100M params: 16L x 640d x 10H, 16k vocab (qwen2.5 family,
        # shrunk)
        base = get_config("qwen2.5-3b")
        cfg = dataclasses.replace(
            base, name="qwen2.5-100m", num_layers=16, d_model=640,
            num_heads=10, num_kv_heads=2, head_dim=64, d_ff=2560,
            vocab_size=16384, remat="none")
    model = build_model(cfg)
    print(f"model: {cfg.name}, {cfg.param_count() / 1e6:.0f}M params, "
          f"on {dev}")

    if tcfg is None:
        tcfg = TrainConfig(learning_rate=2e-3, total_steps=args.steps,
                           warmup_steps=20, checkpoint_every=50, seed=0)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cm = CheckpointManager(ckpt_dir)
    fault = FaultInjector((args.fail_at,)) if args.fail_at else None

    restarts = 0
    while True:
        try:
            out = train_loop(model, tcfg, batch=args.batch, seq=args.seq,
                             steps=args.steps, ckpt_manager=cm, fault=fault,
                             log_every=10, device=dev)
            break
        except RuntimeError as e:
            restarts += 1
            print(f"[supervisor] {e}; restarting from last checkpoint "
                  f"(restart {restarts})")
            if restarts > 3:
                raise

    ran = args.steps - out["start"]
    print(f"\n{args.steps} steps, {restarts} restarts, "
          f"{out['wall_s']:.0f}s wall")
    print(f"last run: steps {out['start']}-{args.steps - 1}, "
          f"{1e3 * out['wall_s'] / max(ran, 1):.1f} ms a step (host clock, "
          "checkpoints included)")
    for step, loss in out["history"]:
        print(f"  step {step:4d}  loss {loss:.4f}")
    first, last = out["history"][0][1], out["final_loss"]
    assert last < first, "loss did not improve"
    print(f"loss {first:.3f} -> {last:.3f}  [improved]")
    return dict(out, restarts=restarts)


if __name__ == "__main__":
    main()
