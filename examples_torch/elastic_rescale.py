"""Example: elastic scaling on the PyTorch port — train, checkpoint, then
restore the same state onto a differently-shaped mesh and continue.
On the production pods this is the 256-chip -> 512-chip rescale path
(checkpoints are mesh-agnostic; shardings are reapplied on restore).

One process a rank. Under torchrun the process group comes from the
environment it sets (RANK, WORLD_SIZE, MASTER_ADDR, ...): gloo on the CPU,
NCCL on the cards. Run alone, it starts a one-rank group of its own:

  PYTHONPATH=src torchrun --nproc-per-node 4 \\
      examples_torch/elastic_rescale.py --device cpu
  PYTHONPATH=src python examples_torch/elastic_rescale.py   # one card

Port of ``examples/elastic_rescale.py``, which makes its devices with
``--xla_force_host_platform_device_count`` in one process.
"""
import argparse
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import TrainConfig, get_smoke
from repro_torch.device import resolve
from repro_torch.distributed.sharding import (Sharding, make_rules,
                                              mesh_shape, spec_placements)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model
from repro_torch.models.layers import sharding_tree
from repro_torch.training.optimizer import AdamW, AdamWState
from repro_torch.training.trainer import train_loop

CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_elastic_example")


def start_group(dev) -> bool:
    """Start the process group unless one is running: from torchrun's
    environment when it is set, else one rank on a local store. NCCL on
    the card, gloo on the CPU. Returns whether it started one."""
    if dist.is_initialized():
        return False
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    return True


class RankZeroWrites(CheckpointManager):
    """Checkpoints of a state that every rank holds whole (unsharded
    training, the same on every rank). The ranks meet before each save,
    so no rank restores past a commit the others have not reached, and
    rank 0 alone writes: one writer per step directory."""

    def save(self, state, step, *, block=False):
        dist.barrier()
        if dist.get_rank() == 0:
            super().save(state, step, block=block)


def main(argv=None, *, ckpt_dir=CKPT_DIR):
    """Returns the phases' train_loop results, the restored step and the
    resharded state (DTensors on the new mesh)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card; raises without one) "
                         "or cpu")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    started = start_group(dev)
    try:
        return _rescale(dev, ckpt_dir)
    finally:
        if started:
            dist.destroy_process_group()


def _rescale(dev, ckpt_dir):
    rank, n_dev = dist.get_rank(), dist.get_world_size()

    def say(*a):
        if rank == 0:
            print(*a, flush=True)

    say(f"{n_dev} devices visible ({dist.get_backend()} ranks on "
        f"{dev.type})")

    cfg = get_smoke("qwen2.5-3b", d_model=64, heads=4, d_ff=128)
    model = build_model(cfg)
    tcfg = TrainConfig(total_steps=40, warmup_steps=4, checkpoint_every=10)
    if rank == 0:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    dist.barrier()
    cm = RankZeroWrites(ckpt_dir)

    # phase 1: train 20 steps (every rank the same unsharded state)
    out1 = train_loop(model, tcfg, batch=4, seq=64, steps=20,
                      ckpt_manager=cm, log_every=5, device=dev)
    dist.barrier()              # rank 0's last commit is on disk
    say("phase 1 final loss:", out1["final_loss"])

    # phase 2: 'rescale' — restore the same checkpoint onto a (n, 1) mesh
    mesh2 = make_local_mesh((n_dev, 1), device=dev)
    rules2 = make_rules(cfg, mesh2)
    shardings = sharding_tree(model.param_defs(), rules2)
    opt = AdamW(tcfg, cfg.moment_dtype)
    params0 = model.init(0, device=dev)
    like = {"params": params0, "opt": opt.init(params0)}
    replicated = Sharding(mesh2, spec_placements(mesh2, ()))
    state, step = cm.restore_latest(like=like, shardings={
        "params": shardings,
        "opt": AdamWState(m=shardings, v=shardings, count=replicated)})
    say(f"restored step {step} onto mesh {mesh_shape(mesh2)}; "
        f"params resharded for {n_dev} devices")

    # phase 3: continue training from the restored state. As in the
    # reference, this resumes from the commit on its own and trains
    # unsharded (no `rules`); the resharded state above is only shown.
    out2 = train_loop(model, tcfg, batch=4, seq=64, steps=40,
                      ckpt_manager=cm, log_every=5, device=dev)
    say("phase 3 final loss:", out2["final_loss"])
    assert out2["final_loss"] < out1["final_loss"]
    say("elastic rescale OK: loss continued to improve after resharding")
    return {"phase1": out1, "phase3": out2, "step": step, "state": state,
            "mesh": mesh2}


if __name__ == "__main__":
    main()
