"""AdamW + LR schedule (PyTorch).

Port of ``repro/training/optimizer.py``: the same fp32 operations in the
same order. The update is in place: it writes the new params and moments
into the tensors it is given (the reference's jitted train step donates
them), one slice of a stacked leaf at a time, so that the fp32
temporaries stay small beside a multi-GB leaf. Moment dtype is per model
(``moment_dtype``: fp32 by default, bf16 for qwen3-moe-235b-a22b).

On a mesh the params, grads and moments are DTensors of one layout per
leaf (``param_pspecs``, ``state_pspecs``). The update is elementwise, so
it runs on each rank's local blocks (their placements must match); the
global norm sums each rank's local squares, each leaf divided by the
number of ranks that hold a copy of its block, in one all-reduce over
the mesh. The step count and the metrics are plain tensors, the same on
every rank: replicated scalars.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.distributed.spmd import is_dtensor
from repro_torch.models.layers import _DTYPES
from repro_torch.tree import leaves, tree_map

# values a slice of a leaf holds in the update (fp32 temporaries of
# 128 MB each)
SLICE_VALUES = 1 << 25


class AdamWState(NamedTuple):
    m: dict
    v: dict
    count: torch.Tensor


def warmup_cosine(lr: float, warmup: int, total: int, floor: float = 0.1):
    def sched(step):
        step = torch.as_tensor(step).float()
        w = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return lr * w * (floor + (1 - floor) * cos)
    return sched


def _slices(x: torch.Tensor) -> list:
    """Views of x along its first axis, each at most SLICE_VALUES values
    (a row more where one row is larger)."""
    if x.dim() == 0 or x.numel() <= SLICE_VALUES:
        return [x]
    rows = max(1, SLICE_VALUES // (x.numel() // x.shape[0]))
    return list(x.split(rows, 0))


def _local(x) -> torch.Tensor:
    """A DTensor's local block (an alias: writes reach the DTensor)."""
    return x.to_local() if is_dtensor(x) else x


def _copies(x) -> int:
    """How many ranks hold each block of x: the sizes of the mesh dims
    it is replicated on (1 for a plain tensor)."""
    if not is_dtensor(x):
        return 1
    n = 1
    for size, pl in zip(x.device_mesh.shape, x.placements):
        if pl.is_partial():
            raise ValueError("global_norm of a Partial DTensor; bring it to "
                             "its param's placements first")
        if pl.is_replicate():
            n *= size
    return n


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32; over a mesh,
    one all-reduce of each rank's local sums."""
    xs = leaves(tree)
    sums = [sum(torch.sum(torch.square(s.float())) for s in
                _slices(_local(x))) for x in xs]
    meshes = {x.device_mesh for x in xs if is_dtensor(x)}
    if not meshes:
        return torch.sqrt(torch.sum(torch.stack(sums)))
    if len(meshes) > 1:
        raise ValueError("global_norm over DTensors of several meshes")
    import torch.distributed as dist
    (mesh,) = meshes
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a mesh of {mesh.size()} ranks in a world of "
                         f"{dist.get_world_size()}: the norm sums over the "
                         "world")
    tot = torch.sum(torch.stack([t / _copies(x) for t, x in zip(sums, xs)]))
    dist.all_reduce(tot)
    return torch.sqrt(tot)


def clip_by_global_norm(tree, max_norm: float):
    """Scales every leaf IN PLACE by min(1, max_norm / norm), in fp32 and
    rounded back to the leaf's dtype. Returns (tree, norm)."""
    gn = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for x in leaves(tree):
        for s in _slices(_local(x)):
            s.copy_(s.float() * scale)
    return tree, gn


class AdamW:
    def __init__(self, tcfg, moment_dtype: str = "float32"):
        self.cfg = tcfg
        self.sched = warmup_cosine(tcfg.learning_rate, tcfg.warmup_steps,
                                   tcfg.total_steps)
        self.moment_dtype = _DTYPES[moment_dtype]

    def init(self, params) -> AdamWState:
        """Zero moments in the params' layout (DTensors of the same
        placements on a mesh) and a zero step count."""
        def zeros(p):
            if is_dtensor(p):
                return torch.zeros_like(p, dtype=self.moment_dtype)
            return torch.zeros(p.shape, dtype=self.moment_dtype,
                               device=p.device)
        some = leaves(params)
        dev = _local(some[0]).device if some else None
        return AdamWState(m=tree_map(zeros, params),
                          v=tree_map(zeros, params),
                          count=torch.zeros((), dtype=torch.int32,
                                            device=dev))

    def abstract_state(self, abstract_params) -> AdamWState:
        """The state's shapes and dtypes as meta tensors."""
        zeros = lambda p: torch.empty(p.shape, dtype=self.moment_dtype,
                                      device="meta")
        return AdamWState(m=tree_map(zeros, abstract_params),
                          v=tree_map(zeros, abstract_params),
                          count=torch.empty((), dtype=torch.int32,
                                            device="meta"))

    def state_pspecs(self, param_pspecs):
        from repro_torch.distributed.sharding import PartitionSpec as P
        return AdamWState(m=param_pspecs, v=param_pspecs, count=P())

    def update(self, grads, state: AdamWState, params):
        """One step: clips `grads` and updates `params`, state.m and
        state.v, all IN PLACE. Returns (params, new state, {"grad_norm",
        "lr"})."""
        c = self.cfg
        grads, gnorm = clip_by_global_norm(grads, c.grad_clip)
        count = state.count
        if is_dtensor(count):          # a restored replicated scalar
            count = count.full_tensor()
        count = count + 1
        b1, b2 = c.b1, c.b2
        bc1 = 1 - b1 ** count.float()
        bc2 = 1 - b2 ** count.float()
        lr = self.sched(count)

        def upd(p, g, m, v):
            gf = g.float()
            mf = m.float() * b1 + gf * (1 - b1)
            vf = v.float() * b2 + gf * gf * (1 - b2)
            step = (mf / bc1) / (torch.sqrt(vf / bc2) + c.eps)
            step = step + c.weight_decay * p.float()
            new_p = p.float() - lr * step
            p.copy_(new_p)
            m.copy_(mf)
            v.copy_(vf)

        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state.m), leaves(state.v)):
            if is_dtensor(p) and not (p.placements == g.placements
                                       == m.placements == v.placements):
                raise ValueError(
                    f"param {p.placements}, grad {g.placements}, moments "
                    f"{m.placements}, {v.placements}: the update runs on "
                    "local blocks of one layout")
            for sl in zip(*(_slices(_local(t)) for t in (p, g, m, v))):
                upd(*sl)
        return params, AdamWState(state.m, state.v, count), {
            "grad_norm": gnorm, "lr": lr}
