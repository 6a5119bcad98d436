"""Train-step builder: loss -> grads (optionally microbatched) -> AdamW
update, plus a supervised training loop with fault injection,
checkpoint/restart and deterministic step-indexed data (see
launch/train.py for the CLI).

Port of ``repro/training/trainer.py``. Gradients come from
``torch.autograd`` over the loss of ``models/api.Model``. The step
updates the params and optimizer state it is given in place, as the
reference's jitted, donating step does; keep a copy to step twice from
the same params. ``jit_train_step`` (mesh sharding) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.device import resolve
from repro_torch.models.api import Model
from repro_torch.training.optimizer import AdamW, AdamWState
from repro_torch.tree import flatten, leaves, tree_map, unflatten


@dataclasses.dataclass
class TrainState:
    params: dict
    opt: AdamWState
    step: int


def value_and_grad(loss_fn, params, batch):
    """(loss, grads) of loss_fn(params, batch); grads have the params'
    tree and dtypes (zeros where a param does not reach the loss)."""
    flat, treedef = flatten(params)
    live = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        loss = loss_fn(unflatten(treedef, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), unflatten(treedef, list(grads))


def build_train_step(model: Model, tcfg: TrainConfig) -> tuple:
    """Returns (train_step, opt): train_step(params, opt_state, batch) ->
    (params, opt_state, metrics), updating params and opt_state in
    place. With tcfg.microbatches > 1 the batch is split on its first
    axis and the microbatch grads are summed in fp32, then divided by
    their count."""
    opt = AdamW(tcfg, model.cfg.moment_dtype)

    def train_step(params, opt_state, batch):
        if tcfg.microbatches > 1:
            mb = tcfg.microbatches
            batches = tree_map(
                lambda x: x.reshape(mb, x.shape[0] // mb, *x.shape[1:]),
                batch)
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(mb):
                l, g = value_and_grad(model.loss, params,
                                      tree_map(lambda x: x[i], batches))
                for acc, gi in zip(leaves(grads), leaves(g)):
                    acc.add_(gi)
                del g
                loss = loss + l
            loss = loss / mb
            for acc in leaves(grads):
                acc.div_(mb)
        else:
            loss, grads = value_and_grad(model.loss, params, batch)
        new_p, new_opt, metrics = opt.update(grads, opt_state, params)
        return new_p, new_opt, dict(metrics, loss=loss)

    return train_step, opt


class FaultInjector:
    """Deterministic simulated node failures for fault-tolerance tests."""

    def __init__(self, fail_steps: tuple[int, ...] = ()):
        self.fail_steps = set(fail_steps)
        self.fired: set[int] = set()

    def maybe_fail(self, step: int):
        if step in self.fail_steps and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


def data_batch(cfg: ModelConfig, tcfg: TrainConfig, step: int,
               batch: int, seq: int, *, device=None) -> dict:
    """Deterministic step-indexed batch on `device` (default: the card):
    restart-safe without data-loader state (the PRNG is a pure function
    of (seed, step)), and the reference's batch value for value."""
    from repro_torch.data.workloads import lm_token_batch
    dev = resolve(device)
    rng = np.random.default_rng((tcfg.seed, step))
    if cfg.family == "encdec":
        frames = rng.normal(size=(batch, seq, cfg.d_model)) * 0.1
        dec = rng.integers(0, cfg.vocab_size,
                           size=(batch, cfg.dec_len + 1))
        # jnp.asarray(float64 frames, bfloat16) rounds to fp32, then to
        # bf16; so does this
        frames = torch.from_numpy(frames.astype(np.float32))
        return {"frames": frames.to(torch.bfloat16).to(dev),
                "dec_tokens": torch.from_numpy(dec.astype(np.int32)).to(dev)}
    toks = lm_token_batch(rng, cfg.vocab_size, batch, seq + 1,
                          motif_seed=tcfg.seed)
    return {"tokens": torch.from_numpy(np.asarray(toks, np.int32)).to(dev)}


def train_loop(model: Model, tcfg: TrainConfig, *, batch: int, seq: int,
               steps: int, ckpt_manager=None,
               fault: Optional[FaultInjector] = None, log_every: int = 10,
               resume: bool = True, device=None) -> dict:
    """Supervised loop on `device` (default: the card): restores from the
    last checkpoint if present, injects faults if configured (caller
    catches + restarts), checkpoints periodically. Returns final metrics
    + loss history."""
    dev = resolve(device)
    step_fn, opt = build_train_step(model, tcfg)

    start = 0
    params = model.init(tcfg.seed, device=dev)
    opt_state = opt.init(params)
    if ckpt_manager is not None and resume:
        restored = ckpt_manager.restore_latest(
            like={"params": params, "opt": opt_state}, device=dev)
        if restored is not None:
            state, start = restored
            params, opt_state = state["params"], state["opt"]

    history = []
    t0 = time.time()
    for step in range(start, steps):
        if fault is not None:
            fault.maybe_fail(step)
        batch_data = data_batch(model.cfg, tcfg, step, batch, seq,
                                device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch_data)
        if (step + 1) % log_every == 0 or step == steps - 1:
            history.append((step, float(metrics["loss"])))
        if ckpt_manager is not None and \
                (step + 1) % tcfg.checkpoint_every == 0:
            ckpt_manager.save({"params": params, "opt": opt_state},
                              step + 1)
    if ckpt_manager is not None:
        ckpt_manager.save({"params": params, "opt": opt_state}, steps)
        ckpt_manager.wait()
    return {
        "history": history,
        "final_loss": history[-1][1] if history else None,
        "steps": steps,
        "wall_s": time.time() - t0,
        "params": params,
        "opt": opt_state,
    }
