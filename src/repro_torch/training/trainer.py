"""Train-step builder: loss -> grads (optionally microbatched) -> AdamW
update, with a sharding-rules context, plus a supervised training loop
with fault injection, checkpoint/restart and deterministic step-indexed
data (see launch/train.py for the CLI).

Port of ``repro/training/trainer.py``. Gradients come from
``torch.autograd`` over the loss of ``models/api.Model``. The step
updates the params and optimizer state it is given in place, as the
reference's jitted, donating step does; keep a copy to step twice from
the same params. ``jit_train_step`` is the sharded step: params and
moments are DTensors on the rules' mesh, laid out by ``param_pspecs``
and ``state_pspecs``, the batch is sharded on the data axes, DTensor
partitions the loss and its gradient, and the grads are brought to the
params' layout (a reduce-scatter) before the update.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.device import resolve
from repro_torch.distributed.sharding import (Rules, Sharding,
                                              spec_placements, use_rules)
from repro_torch.distributed.spmd import is_dtensor, shard_dim
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


@contextlib.contextmanager
def partitioned(rules: Optional[Rules]):
    """The rules' context, and DTensor's implicit replication of the
    plain tensors the model makes (positions, masks) when it has a
    mesh. Held around the forward and the backward alike: the backward
    recomputes rematerialized layers."""
    with use_rules(rules), contextlib.ExitStack() as stack:
        if rules is not None:
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            stack.enter_context(implicit_replication())
        yield


def _replicated(loss):
    """A DTensor loss summed and replicated on every rank, as the
    reference's scalar output: its gradient seed is then the same 1 on
    every rank."""
    if not is_dtensor(loss):
        return loss
    from torch.distributed.tensor import Replicate
    return loss.redistribute(loss.device_mesh,
                             [Replicate()] * loss.device_mesh.ndim)


def _to_param_layout(g, p):
    """A grad in its param's layout: partial sums reduced and scattered
    (a reduce-scatter) or all-reduced, as the placements ask."""
    if is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _rows_gathered(x):
    """A batch leaf with every rank holding all its rows: a DTensor
    sharded on its batch dim is gathered on that dim (its other
    placements kept); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if shard_dim(p) == 0 else p for p in x.placements])


def microbatch(x, rows, mb: int, i: int):
    """Microbatch i of mb of the batch leaf x: global rows
    [i b/mb, (i+1) b/mb), as the reference's reshape and scan take them,
    cut from `rows` (``_rows_gathered(x)``) and laid out as x is, so that
    each microbatch holds the same rows on any mesh."""
    n = x.shape[0] // mb
    part = rows[i * n:(i + 1) * n]
    if is_dtensor(x):
        return part.redistribute(x.device_mesh, x.placements)
    return part


def build_train_step(model: Model, tcfg: TrainConfig,
                     rules: Optional[Rules] = None) -> tuple:
    """Returns (train_step, opt): train_step(params, opt_state, batch) ->
    (params, opt_state, metrics), updating params and opt_state in
    place; the loss runs under `rules` (None: no mesh). With
    tcfg.microbatches > 1 the batch is split on its first axis
    (``microbatch``) and the microbatch grads are summed in fp32, then
    divided by their count."""
    opt = AdamW(tcfg, model.cfg.moment_dtype)

    def loss_fn(params, batch):
        return _replicated(model.loss(params, batch))

    def grads_of(params, batch):
        with partitioned(rules):
            loss, grads = value_and_grad(loss_fn, params, batch)
        return loss, tree_map(_to_param_layout, grads, params)

    def train_step(params, opt_state, batch):
        if tcfg.microbatches > 1:
            mb = tcfg.microbatches
            loss = None
            rows = tree_map(_rows_gathered, batch)
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32) if is_dtensor(p) else torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(mb):
                l, g = grads_of(params, tree_map(
                    lambda x, r: microbatch(x, r, mb, i), batch, rows))
                for acc, gi in zip(leaves(grads), leaves(g)):
                    acc.add_(gi)
                del g
                loss = l if loss is None else loss + l
            loss = loss / mb
            for acc in leaves(grads):
                acc.div_(mb)
        else:
            loss, grads = grads_of(params, batch)
        new_p, new_opt, metrics = opt.update(grads, opt_state, params)
        if is_dtensor(loss):           # replicated: every rank's copy
            loss = loss.to_local()
        return new_p, new_opt, dict(metrics, loss=loss)

    return train_step, opt


def shard_tree(tree, shardings):
    """Plain tensors, the same on every rank -> DTensors laid out by a
    tree of ``Sharding``s of the same structure; each rank keeps its own
    blocks (nothing is sent). DTensors already in place pass through."""
    from torch.distributed.tensor import distribute_tensor

    def one(x, sh):
        if is_dtensor(x):
            if tuple(x.placements) != tuple(sh.placements):
                return x.redistribute(sh.mesh, sh.placements)
            return x
        return distribute_tensor(x, sh.mesh, sh.placements,
                                 src_data_rank=None)
    return tree_map(one, tree, shardings)


def jit_train_step(model: Model, tcfg: TrainConfig, rules: Rules,
                   batch_placements):
    """The fully-sharded train step on the rules' mesh. Returns
    (step_fn, opt): step_fn(params, opt_state, batch) -> (params,
    opt_state, metrics). Params and the AdamWState's moments are
    DTensors laid out by ``param_pspecs`` and ``state_pspecs`` (plain
    tensors, the same on every rank, are laid out on entry, as jit's
    in_shardings would); each batch leaf is laid out by its
    PartitionSpec in `batch_placements` (``Model.input_pspecs`` gives
    them). The metrics are replicated scalars, the same plain tensor on
    every rank."""
    mesh = rules.mesh
    step_fn, opt = build_train_step(model, tcfg, rules)
    shardings = model.param_shardings(rules)
    batch_shardings = {k: Sharding(mesh, spec_placements(mesh, v))
                       for k, v in batch_placements.items()}

    def sharded_step(params, opt_state, batch):
        params = shard_tree(params, shardings)
        opt_state = AdamWState(shard_tree(opt_state.m, shardings),
                               shard_tree(opt_state.v, shardings),
                               opt_state.count)
        batch = shard_tree(batch, {k: batch_shardings[k] for k in batch})
        return step_fn(params, opt_state, batch)

    return sharded_step, opt


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
               steps: int, rules: Optional[Rules] = None, ckpt_manager=None,
               fault: Optional[FaultInjector] = None, log_every: int = 10,
               resume: bool = True, device=None) -> dict:
    """Supervised loop on `device` (default: the card): restores from the
    last checkpoint if present, injects faults if configured (caller
    catches + restarts), checkpoints periodically. The loss runs under
    `rules`, as the reference's does. Returns final metrics + loss
    history, and the step it started from (``start``: the restored
    commit's, else 0)."""
    dev = resolve(device)
    step_fn, opt = build_train_step(model, tcfg, rules)

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
        "start": start,
        "wall_s": time.time() - t0,
        "params": params,
        "opt": opt_state,
    }
