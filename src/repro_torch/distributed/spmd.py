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
  embed(table, ids)  -- table[ids], rows of a vocab-sharded embedding
                        table: each rank looks up the ids in its own
                        vocab block and the result is a partial sum.
                        DTensor's own indexing moves the table (whole,
                        or to a split of its other dim) to every rank.
  take_label(lg, y)  -- torch.gather(lg, -1, y[..., None]) of vocab-
                        sharded logits: each rank picks the labels in its
                        own vocab block and the result is a partial sum.
                        DTensor's own gather does that forward, but its
                        backward allocates the gradient at the logits'
                        global shape on every rank.
  unbind(x)          -- torch.unbind(x, 0) of a stacked param, on the
                        local block: each slice keeps the stack's
                        placements one dim lower (_StridedShard too,
                        which DTensor's own unbind in some torch
                        releases does not shift).
  write(buf, i, val) -- buf[:, i] = val in place (a decode cache's new
                        token), on each rank's own block: val is brought
                        to the block's layout, the buffer never moves.
"""
from __future__ import annotations

import torch


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard_dim(p):
    """The tensor dim a placement splits (Shard or _StridedShard, which
    is not a Shard in every torch release), else None."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    return p.dim if isinstance(p, (Shard, _StridedShard)) else None


def block_offset(shape, mesh, placements) -> tuple:
    """The global index of the first element of this rank's block of an
    evenly sharded tensor, per dim (from the mesh coordinate alone, so
    that it holds under FakeTensorMode too)."""
    coord = mesh.get_coordinate()
    off = [0] * len(shape)
    size = list(shape)
    for i, p in enumerate(placements):
        d = shard_dim(p)
        if d is None:
            continue
        if type(p).__name__ != "Shard":
            raise ValueError(f"block offset of a {p}")
        size[d] //= mesh.size(i)
        off[d] += coord[i] * size[d]
    return tuple(off)


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


def write(buf, index: int, val):
    """buf[:, index] = val, in place. On a DTensor buffer, dim 1 must be
    replicated: val (buf's shape without dim 1) is laid out as buf's
    slice at `index` is, and each rank writes its own block; the buffer
    keeps its placements and nothing of it is sent."""
    if not is_dtensor(buf):
        buf[:, index] = val
        return buf
    from torch.distributed.tensor import DTensor, Replicate, Shard
    want = []
    for p in buf.placements:
        d = shard_dim(p)
        if d is not None:
            if d == 1 or type(p) is not Shard:
                raise ValueError(f"write into dim 1 of a buffer laid out "
                                 f"{tuple(buf.placements)}")
            want.append(Shard(d - (d > 1)))
        else:
            want.append(Replicate())
    if not is_dtensor(val):
        val = DTensor.from_local(val, buf.device_mesh,
                                 [Replicate()] * buf.device_mesh.ndim,
                                 run_check=False)
    if tuple(val.placements) != tuple(want):
        val = val.redistribute(buf.device_mesh, want)
    buf.to_local()[:, index] = val.to_local()
    return buf


def embed(table, ids):
    """table[ids] for a (vocab, d) table. On a DTensor table split by
    ``Shard``s, on local blocks: the ids are gathered on the mesh dims
    that split the table; a rank whose vocab block lacks an id gives 0
    there and the vocab-split mesh dims sum (a Partial result); a split
    of d stays on the result's last dim. The table never moves."""
    if not is_dtensor(table) or any(
            shard_dim(p) is not None and type(p).__name__ != "Shard"
            for p in table.placements):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    ids_pl, out_pl = [], []
    for t, i in zip(table.placements, ids.placements):
        d = shard_dim(t)
        ids_pl.append(i if d is None else Replicate())
        out_pl.append(i if d is None else
                      Partial() if d == 0 else Shard(ids.ndim))
    off = block_offset(table.shape, mesh, table.placements)[0]

    def fn(tb, ix):
        n = tb.shape[0]
        ix = ix.long() - off
        ok = (ix >= 0) & (ix < n)
        return torch.where(ok[..., None], tb[ix.clamp(0, n - 1)], 0.0)
    return local(fn, (table, ids), (list(table.placements), ids_pl),
                 [out_pl])


def take_label(logits, labels):
    """torch.gather(logits, -1, labels[..., None]): the (..., 1) label
    logits. On a DTensor, on local blocks: labels follow the logits'
    leading dims; a rank whose vocab block lacks a label gives 0 there,
    and the vocab-split mesh dims sum (a Partial result), so that the
    backward stays on each rank's own block."""
    if not is_dtensor(logits):
        return torch.gather(logits, -1, labels[..., None].long())
    from torch.distributed.tensor import DTensor, Partial, Replicate
    last = logits.ndim - 1
    mesh = logits.device_mesh
    pl = list(logits.placements)
    if not is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    vocab = [p.is_shard(last) for p in pl]
    lab_pl = [Replicate() if v else p for p, v in zip(pl, vocab)]
    out_pl = [Partial() if v else p for p, v in zip(pl, vocab)]
    off = block_offset(logits.shape, mesh, pl)[last]

    def fn(lg, lb):
        n = lg.shape[-1]
        idx = lb.long()[..., None] - off
        ok = (idx >= 0) & (idx < n)
        return torch.where(ok, torch.gather(lg, -1, idx.clamp(0, n - 1)),
                           0.0)
    return local(fn, (logits, labels), (pl, lab_pl), [out_pl])


def unbind(x):
    """torch.unbind(x, 0). On a DTensor whose dim 0 is not split: one
    DTensor a slice of the local block, its placements those of x one dim
    lower; autograd stacks the slices' gradients back into x's layout."""
    if not is_dtensor(x):
        return torch.unbind(x, 0)
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    pl = []
    for p in x.placements:
        d = shard_dim(p)
        if d == 0:
            raise ValueError(f"unbind of a dim laid out {p}")
        if d is None:
            pl.append(p)
        elif isinstance(p, _StridedShard):
            pl.append(_StridedShard(d - 1, split_factor=p.split_factor))
        else:
            pl.append(Shard(d - 1))
    shape = tuple(x.shape[1:])
    stride = tuple(torch.empty(shape, device="meta").stride())
    return tuple(DTensor.from_local(t, x.device_mesh, pl, run_check=False,
                                    shape=shape, stride=stride)
                 for t in torch.unbind(x.to_local(
                     grad_placements=x.placements), 0))
