"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake
process group (PyTorch).

Port of ``repro/launch/dryrun.py``. For each cell this builds the real
step function (the sharded train step with its AdamW update, prefill,
or the decode serve_step), lays its params, optimizer state and inputs
out as DTensors of fake tensors on the production mesh (16x16 = 256
ranks, or 2x16x16 = 512) over a fake process group, runs it once, and
records rank 0's share: its memory, the flops and bytes of its local
ops, the collectives it issued, and their roofline terms for one
NVIDIA H100 (``distributed/roofline.py``). Nothing is allocated and no
data moves: fake tensors carry shapes only.

Where XLA compiles the whole step and reports its cost, the port counts
what rank 0 runs, op by op, under a dispatch mode that sees the local
ops DTensor issues (never the DTensor ops themselves, whose flops would
be the global op's):
  flops   -- torch.utils.flop_counter's formulas (matmuls, convolutions,
             attention kernels) over the local ops, the recomputation of
             rematerialized layers included;
  bytes   -- the input plus output bytes of every local op that is not a
             view or a collective, unfused (XLA's "bytes accessed");
             distributed/analytic.analytic_bytes is recorded beside it;
  memory  -- the storages the step allocates, tracked until they are
             freed: argument bytes, the peak of what the step allocated,
             and what of it is still live at the end (new outputs).
The ops DTensor runs to infer a result's global shape (sharding
propagation) are not rank 0's work and are not counted.

A CPU mesh (``--device cpu``, for machines without a card) cannot issue
all-to-alls: DTensor emulates them with an all-gather and a chunk, so a
CPU dry run reports all-gathers where the card's NCCL mesh runs
all-to-alls (MoE dispatch, Shard(i) -> Shard(j) changes).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out results/dryrun_torch [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, TrainConfig,
                                 get_config, shape_applicable)
from repro_torch.distributed.analytic import analytic_bytes
from repro_torch.distributed.roofline import (parse_collectives,
                                              record_collective,
                                              roofline_terms)
from repro_torch.distributed.sharding import (PartitionSpec, Sharding,
                                              make_rules, spec_placements)
from repro_torch.distributed.spmd import shard_dim
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.api import lay_out
from repro_torch.training.optimizer import AdamW

# per-arch gradient-accumulation factors for train_4k (the reference's):
# divides activation residuals + MoE dispatch buffers
MICROBATCHES = {
    "qwen3-moe-235b-a22b": 16,
    "chameleon-34b": 8,
    "granite-moe-3b-a800m": 4,
    "phi3-medium-14b": 4,
    "gemma-2b": 2,
}

# a cell whose trace runs longer than this stops and says so in its
# record (the longest full-size cell traces in about half of it)
CELL_LIMIT_S = 3600.0


class CellTimeout(RuntimeError):
    pass


# ---------------------------------------------------------------- counting


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


# allocations write nothing; "like" factories read only their template's
# shape and dtype
_ALLOC = {"empty", "empty_strided", "empty_like", "new_empty",
          "new_empty_strided"}
_LIKE = {"zeros_like", "ones_like", "full_like", "new_zeros", "new_ones",
         "new_full", "rand_like", "randn_like"}


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes a local op reads and writes, unfused: its tensor inputs
    and outputs; nothing for a view, an allocation or an op that returns
    no tensor; the output only for a factory shaped like its input."""
    outs = _tensors(out)
    name = func._overloadpacket.__name__
    if not outs or _is_view(func) or name in _ALLOC:
        return 0
    ts = outs if name in _LIKE else _tensors((args, kwargs)) + outs
    return sum(t.numel() * t.element_size() for t in ts)


class _Propagating:
    """Marks the ops DTensor's sharding propagation runs on global-shape
    fake tensors to infer a result's shape: not rank 0's work."""
    depth = 0
    _saved: list = []

    @classmethod
    def install(cls):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        for name in ("_propagate_tensor_meta_non_cached",
                     "_propagate_tensor_meta"):
            orig = ShardingPropagator.__dict__.get(name)
            if orig is None:
                continue

            def wrapped(*a, _orig=orig, **k):
                cls.depth += 1
                try:
                    return _orig(*a, **k)
                finally:
                    cls.depth -= 1
            cls._saved.append((ShardingPropagator, name, orig))
            setattr(ShardingPropagator, name, wrapped)
            break
        else:
            raise RuntimeError("DTensor's tensor-meta propagation not found")

    @classmethod
    def uninstall(cls):
        while cls._saved:
            owner, name, orig = cls._saved.pop()
            setattr(owner, name, orig)


class Counter(TorchDispatchMode):
    """Rank 0's local ops: flops, bytes, collectives and live storage.

    Returns NotImplemented for an op on DTensors, so that DTensor runs it
    and this mode sees the local ops it issues (and the collectives of
    its redistributions). `known` storages (the arguments') are never
    counted as allocations."""

    def __init__(self, known=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.collectives: list = []
        self.by_op: dict = {}          # op -> [count, flops, bytes]
        self.live = 0
        self.peak = 0
        self._seen = {id(st) for st in known}
        self.t0 = time.time()

    def _track(self, out):
        for t in _tensors(out):
            st = t.untyped_storage()
            if id(st) in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(id(st))
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, id(st), n)

    def _free(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(isinstance(t, DTensor) for t in _tensors((args, kwargs))):
            return NotImplemented
        out = func(*args, **kwargs)
        if _Propagating.depth:
            return out
        self.ops += 1
        if self.ops % 4096 == 0 and time.time() - self.t0 > CELL_LIMIT_S:
            raise CellTimeout(f"trace exceeded the {CELL_LIMIT_S:.0f} s "
                              f"cell limit after {self.ops} local ops")
        rec = record_collective(func, args, kwargs, out)
        if rec is not None:
            self.collectives.append(rec)
        elif func.namespace != "_c10d_functional":
            pk = func._overloadpacket
            ent = self.by_op.setdefault(str(pk), [0, 0, 0])
            ent[0] += 1
            if pk in self.flop_registry:
                f = self.flop_registry[pk](*args, **kwargs, out_val=out)
                self.flops += f
                ent[1] += f
            b = op_bytes(func, args, kwargs, out)
            self.bytes += b
            ent[2] += b
        self._track(out)
        return out


# ------------------------------------------------------------ fake inputs


def _zip_map(fn, a, b, leaf):
    """fn(x, y) over the leaves x of tree `a` (those `leaf` accepts) and
    the like-placed parts y of tree `b` (dicts, tuples, NamedTuples)."""
    if leaf(a):
        return fn(a, b)
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k], leaf) for k in a}
    parts = [_zip_map(fn, x, y, leaf) for x, y in zip(a, b)]
    return type(a)(*parts) if hasattr(a, "_fields") else type(a)(parts)


def shardings(mesh, specs):
    """A tree of PartitionSpecs -> the like tree of ``Sharding``s."""
    return _zip_map(lambda s, _: Sharding(mesh, spec_placements(mesh, s)),
                    specs, specs, lambda x: isinstance(x, PartitionSpec))


def local_shape(shape, mesh, placements) -> tuple:
    """Rank 0's block of an evenly sharded tensor."""
    out = list(shape)
    for i, p in enumerate(placements):
        d = shard_dim(p)
        if d is not None:
            n = mesh.size(i)
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"split {n} ways")
            out[d] //= n
    return tuple(out)


def fake_dtensor(meta, sharding, device):
    """A DTensor of `meta`'s global shape and dtype whose local block is
    an empty tensor (a fake one under FakeTensorMode) on `device`."""
    from torch.distributed.tensor import DTensor
    loc = torch.empty(local_shape(meta.shape, sharding.mesh,
                                  sharding.placements),
                      dtype=meta.dtype, device=device)
    return DTensor.from_local(loc, sharding.mesh, sharding.placements,
                              run_check=False, shape=meta.shape,
                              stride=meta.stride())


def _unique_storages(tree):
    """The storages of a tree's tensors (a DTensor's local block), once
    each."""
    seen = {}
    for t in _tensors(tree):
        loc = t.to_local() if hasattr(t, "to_local") else t
        st = loc.untyped_storage()
        seen[id(st)] = st
    return list(seen.values())


# ------------------------------------------------------------------ cells


def build_cell(arch: str, shape_name: str, mesh, *, sp_activations=None,
               cfg=None):
    """Returns (fn, abstract_args, in_shardings, out_axes, donate): fn
    runs the step on DTensors laid out by in_shardings (trees of
    ``Sharding``) and lays its outputs out by out_axes, as a jitted
    function's out_shardings would; `donate` names the args the step
    updates in place. `cfg` replaces the arch's config (calibration's
    reduced depths)."""
    from repro_torch.training.trainer import jit_train_step, partitioned

    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    model = build_model(cfg)
    if sp_activations is None:
        # Megatron-SP inter-block activations by default for training
        sp_activations = shape.kind == "train"
    # decode: weight-stationary layout (no per-step weight gathers)
    rules = make_rules(cfg, mesh, sp_activations=sp_activations,
                       weight_stationary=shape.kind == "decode")

    param_specs = model.param_pspecs(rules)
    abstract_params = model.abstract_params()
    inputs = model.input_specs(shape)
    input_specs = model.input_pspecs(shape, rules)

    if shape.kind == "train":
        micro = MICROBATCHES.get(arch, 1)
        # each microbatch must still shard over the data axes
        n_data = rules.axis_size(rules.table["batch"])
        while micro > 1 and (shape.global_batch // micro) % n_data:
            micro //= 2
        tcfg = TrainConfig(microbatches=micro)
        opt = AdamW(tcfg, cfg.moment_dtype)
        abs_opt = opt.abstract_state(abstract_params)
        opt_specs = opt.state_pspecs(param_specs)
        step, _ = jit_train_step(model, tcfg, rules, input_specs)
        args = (abstract_params, abs_opt, inputs)
        in_sh = (shardings(mesh, param_specs), shardings(mesh, opt_specs),
                 shardings(mesh, input_specs))
        out_axes = ("params", "opt_state", {"grad_norm": (), "lr": (),
                                            "loss": ()})
        return step, args, in_sh, out_axes, (0, 1)

    if shape.kind == "prefill":
        out_axes = model.prefill_out_axes()

        def prefill_step(params, inputs):
            with torch.no_grad(), partitioned(rules):
                return lay_out(model.prefill(params, inputs), out_axes,
                               rules)

        args = (abstract_params, inputs)
        in_sh = (shardings(mesh, param_specs), shardings(mesh, input_specs))
        return prefill_step, args, in_sh, out_axes, ()

    # decode / serve_step: the first token after the context (enc-dec:
    # the decoder's first position)
    pos = 0 if cfg.family == "encdec" else shape.seq_len
    out_axes = (("batch", "act_vocab"), model.cache_axes())

    def serve_step(params, cache, token):
        with torch.no_grad(), partitioned(rules):
            out = model.decode_step(params, cache, token, pos)
            return lay_out(out, out_axes, rules)

    args = (abstract_params, inputs["cache"], inputs["token"])
    in_sh = (shardings(mesh, param_specs),
             shardings(mesh, input_specs["cache"]),
             shardings(mesh, input_specs["token"]))
    return serve_step, args, in_sh, out_axes, (1,)


# ----------------------------------------------------- the process group


_MESHES: dict = {}


def fake_world(n: int):
    """A fake process group of n ranks, this process rank 0: the one
    running, or a new one (any other group is destroyed first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if (dist.get_world_size() == n
                and dist.get_backend() == "fake"):
            return
        dist.destroy_process_group()
        _MESHES.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def production_mesh(multi_pod: bool, device):
    """The production mesh over a fake group of its size (one a process
    and device type, reused from cell to cell)."""
    fake_world(512 if multi_pod else 256)
    key = (multi_pod, str(device))
    if key not in _MESHES:
        _MESHES[key] = make_production_mesh(multi_pod=multi_pod,
                                            device=device)
    return _MESHES[key]


def measure(fn, args, in_sh, device):
    """Run fn once on fake DTensors laid out by in_sh; returns its
    outputs, the Counter and the argument storages."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        dargs = _zip_map(lambda sh, meta: fake_dtensor(meta, sh, device),
                         tuple(in_sh), tuple(args),
                         lambda x: isinstance(x, Sharding))
        known = _unique_storages(dargs)
        _Propagating.install()
        try:
            with Counter(known) as counter:
                out = fn(*dargs)
        finally:
            _Propagating.uninstall()
        return out, counter, known


def model_flops(cfg, shape) -> float:
    n_act = cfg.active_param_count()
    if shape.kind == "train":
        return 6 * n_act * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2 * n_act * shape.global_batch * shape.seq_len
    return 2 * n_act * shape.global_batch


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             *, skip_existing=False, verbose=True, sp_activations=None,
             device=None):
    """Trace one cell on the fake production mesh and write its record
    (also returned) to <out_dir>/<mesh>/<arch>__<shape>.json; a failure,
    a trace past CELL_LIMIT_S included, is recorded as FAIL with its
    traceback."""
    from repro_torch.device import resolve
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    os.makedirs(os.path.join(out_dir, mesh_tag), exist_ok=True)
    path = os.path.join(out_dir, mesh_tag, f"{arch}__{shape_name}.json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            return json.load(f)

    dev = resolve(device)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                 "kind": shape.kind, "device": dev.type}
    if not ok:
        rec.update(status="SKIP", reason=why)
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
        return rec

    try:
        t0 = time.time()
        mesh = production_mesh(multi_pod, dev)
        chips = mesh.size()
        fn, args, in_sh, _, _ = build_cell(
            arch, shape_name, mesh, sp_activations=sp_activations)
        out, counter, known = measure(fn, args, in_sh, dev)
        trace_s = time.time() - t0
        arg_bytes = sum(st.nbytes() for st in known)
        new_out = [st for st in _unique_storages(out)
                   if all(st is not k for k in known)]
        out_bytes = sum(st.nbytes() for st in new_out)
        del out
        coll = parse_collectives(counter.collectives)
        flops, nbytes = counter.flops, counter.bytes
        rl = roofline_terms(flops, nbytes, coll)
        mf = model_flops(cfg, shape)
        rec.update(
            status="OK",
            chips=chips,
            trace_s=round(trace_s, 2),
            local_ops=counter.ops,
            memory={
                "argument_bytes": arg_bytes,
                "output_bytes": out_bytes,
                "temp_bytes": counter.peak - out_bytes,
                "peak_est_bytes": arg_bytes + counter.peak,
            },
            cost={"flops_per_dev": flops, "bytes_per_dev": nbytes,
                  "analytic_bytes_per_dev": analytic_bytes(
                      cfg, shape, chips)["bytes_per_dev"]},
            collectives=coll.as_dict(),
            roofline=rl,
            # the local ops that move the most bytes: [count, flops, bytes]
            top_ops=dict(sorted(counter.by_op.items(),
                                key=lambda kv: -kv[1][2])[:8]),
            model_flops=mf,
            useful_flops_ratio=mf / (flops * chips) if flops else 0.0,
            params=cfg.param_count(),
            active_params=cfg.active_param_count(),
        )
        if verbose:
            print(f"[{mesh_tag}] {arch} x {shape_name}: trace "
                  f"{trace_s:.1f}s, {counter.ops} local ops")
            print("  memory:", rec["memory"])
            print("  cost: flops/dev=%.3e bytes/dev=%.3e" % (flops, nbytes))
            print("  collectives:", json.dumps(coll.as_dict()["by_kind"]))
            print("  roofline:", {k: (round(v, 6) if isinstance(v, float)
                                      else v) for k, v in rl.items()},
                  flush=True)
    except Exception as e:  # noqa: BLE001 - record failures as results
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   timed_out=isinstance(e, CellTimeout),
                   trace_s=round(time.time() - t0, 2),
                   traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[{mesh_tag}] {arch} x {shape_name}: FAIL {e}",
                  flush=True)

    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    return rec


def summarize(out_dir: str) -> str:
    """The records under out_dir as one markdown table: a row an arch, a
    column a shape; each cell the 16x16 mesh's record, then the 2x16x16
    one's: status, trace seconds, peak GB a rank (of the card's 80) and
    the dominant roofline term."""
    def cell(tag, arch, shape):
        path = os.path.join(out_dir, tag, f"{arch}__{shape}.json")
        if not os.path.exists(path):
            return "not run"
        with open(path) as f:
            r = json.load(f)
        if r["status"] == "OK":
            return (f"OK {r['trace_s']:.0f} s "
                    f"{r['memory']['peak_est_bytes'] / 1e9:.1f} GB "
                    f"{r['roofline']['dominant']}")
        if r["status"] == "SKIP":
            return "SKIP"
        return "FAIL (time limit)" if r.get("timed_out") else "FAIL"

    lines = ["| arch (16x16 / 2x16x16) | " + " | ".join(SHAPES) + " |",
             "|---|" + "---|" * len(SHAPES)]
    for arch in ASSIGNED_ARCHS:
        row = []
        for shape in SHAPES:
            both = [cell(t, arch, shape) for t in ("pod16x16", "pod2x16x16")]
            row.append("SKIP" if both == ["SKIP"] * 2 else " / ".join(both))
        lines.append(f"| {arch} | " + " | ".join(row) + " |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--sp-activations", default="auto",
                    choices=["auto", "on", "off"],
                    help="Megatron-SP inter-block activations "
                         "(auto = on for train shapes)")
    ap.add_argument("--device", default=None,
                    help="the mesh's device type (default: the card; "
                         "cpu for a machine without one)")
    ap.add_argument("--summarize", action="store_true",
                    help="print the records under --out as tables; run "
                         "nothing")
    args = ap.parse_args(argv)
    if args.summarize:
        print(summarize(args.out))
        return
    sp = None if args.sp_activations == "auto" else args.sp_activations == "on"

    archs = ASSIGNED_ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_ok = n_fail = n_skip = 0
    try:
        for multi in meshes:
            for arch in archs:
                for shape in shapes:
                    rec = run_cell(arch, shape, multi, args.out,
                                   skip_existing=args.skip_existing,
                                   sp_activations=sp, device=args.device)
                    st = rec["status"]
                    n_ok += st == "OK"
                    n_fail += st == "FAIL"
                    n_skip += st == "SKIP"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"\ndry-run complete: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
