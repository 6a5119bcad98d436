"""Where DTensor's own sharding propagation is not what GSPMD does, the
port partitions the computation by hand: each helper lays its DTensor
operands out explicitly, runs the plain torch computation on the local
blocks and wraps the result back into a DTensor. On plain tensors each
helper is the plain computation.

  einsum(eq, x, w)   -- an activation times a weight. torch.einsum flattens
                        its operands into a bmm, and DTensor may shard the
                        flattened dim in a way it cannot unflatten (kv
                        heads 2 over a model axis of 4); here each mesh
                        dim decides as GSPMD does: a weight dim sharded on
                        a contracted letter is all-gathered where the
                        activation is sharded on another letter (FSDP),
                        or the activation is sliced to match it and the
                        result is a partial sum (tensor parallel).
  local(fn, ...)     -- fn over the local blocks of operands laid out by
                        the caller (flash attention, the SSD scan).
"""
from __future__ import annotations

import torch


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _parse(eq: str):
    ins, out = eq.replace(" ", "").split("->")
    a, b = ins.split(",")
    return a, b, out


def _reduce_partials(x):
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.placement_types import _StridedShard
    pl = [Replicate() if (p.is_partial() or isinstance(p, _StridedShard))
          else p for p in x.placements]
    return x if tuple(pl) == tuple(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def einsum(eq: str, x, w):
    """torch.einsum(eq, x, w) for an activation x and a weight w; on
    DTensors, partitioned per mesh dim (module docstring)."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return torch.einsum(eq, x, w)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = (x if is_dtensor(x) else w).device_mesh
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if not is_dtensor(w):
        w = DTensor.from_local(w, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    la, lb, lo = _parse(eq)
    x, w = _reduce_partials(x), _reduce_partials(w)
    px, pw, po = list(x.placements), list(w.placements), []
    for i in range(mesh.ndim):
        cx = la[px[i].dim] if px[i].is_shard() else None
        cw = lb[pw[i].dim] if pw[i].is_shard() else None
        if cw is not None and cw != cx and (cx is not None or cw not in la):
            # the weight's letter collides with the activation's (FSDP:
            # gather the weight), or the activation lacks it
            if cw in lo and cx is None:
                po.append(Shard(lo.index(cw)))       # column parallel
                continue
            pw[i], cw = Replicate(), None
        if cx is not None and cw is None:
            if cx in lo:
                po.append(Shard(lo.index(cx)))
                continue
            if cx in lb:                             # slice w to match
                pw[i], cw = Shard(lb.index(cx)), cx
            else:
                px[i], cx = Replicate(), None
        if cx is None and cw is not None:            # cw contracted, in la
            px[i], cx = Shard(la.index(cw)), cw
        if cx is None:
            po.append(Replicate())
        elif cx in lo:
            po.append(Shard(lo.index(cx)))
        else:
            po.append(Partial())
    if list(x.placements) != px:
        x = x.redistribute(mesh, px)
    if list(w.placements) != pw:
        w = w.redistribute(mesh, pw)
    # an operand replicated on a mesh dim where the result is not has a
    # partial gradient there: each rank holds its own part of the sum
    grad = lambda pl: [Partial() if a.is_replicate() and not b.is_replicate()
                       else a for a, b in zip(pl, po)]
    # every sharded dim divides its mesh dims (the rules' resolver sees
    # to it), so from_local infers the global shape and strides
    out = torch.einsum(eq, x.to_local(grad_placements=grad(px)),
                       w.to_local(grad_placements=grad(pw)))
    return DTensor.from_local(out, mesh, po, run_check=False)


def local(fn, args, in_placements, out_placements):
    """fn(*local blocks of args) -> DTensors laid out by `out_placements`
    (evenly sharded; one entry per output). Each DTensor arg is first
    redistributed to its entry of `in_placements`; other args pass
    through. An arg replicated on a mesh dim where the first output is
    not gets a Partial gradient there: each rank computes a part of it."""
    from torch.distributed.tensor import DTensor, Partial
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    first = out_placements[0]
    grad_placements = [
        [Partial() if a.is_replicate() and not o.is_replicate() else a
         for a, o in zip(pl, first)] for pl in in_placements]
    loc = []
    for a, pl, gp in zip(args, in_placements, grad_placements):
        if is_dtensor(a):
            if tuple(a.placements) != tuple(pl):
                a = a.redistribute(mesh, pl)
            a = a.to_local(grad_placements=gp)
        loc.append(a)
    outs = fn(*loc)
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    res = tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                for o, pl in zip(outs, out_placements))
    return res[0] if single else res
