"""Cost calibration for the roofline table (PyTorch): a check on the dry
run's counters.

Port of ``repro/launch/calibrate.py``. The reference calibrates because
XLA's cost_analysis() counts a lax.scan body once, so its production
compile under-reports flops, bytes and collective traffic. The port's
dry run counts every local op as it runs, eagerly (remat recomputation
included), so nothing is hidden: here the same two-depth extrapolation

    per_unit = (cost(b) - cost(a)) / (b - a)
    total    = cost(a) + per_unit * (L_full - a)

must equal the dry run's direct count at full depth wherever a cost is
linear in depth, and a difference points at a counter that is not.

Depth units per family, as in the reference: layers (dense/moe/ssm),
groups of (attn_every mamba + 1 shared attn) for hybrid, (enc+dec) layer
pairs for encdec. The reduced configs change depth only (the reference
also collapsed its inner scans, which an eager count does not need),
and keep the arch's gradient accumulation. The config goes to
``dryrun.build_cell`` directly.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.calibrate --arch all \\
      --shape all --mesh single [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch.distributed as dist

from repro_torch.configs import SHAPES, get_config, shape_applicable
from repro_torch.distributed.roofline import parse_collectives
from repro_torch.launch.dryrun import build_cell, measure, production_mesh


def _depth_points(cfg):
    if cfg.family == "hybrid":
        return cfg.attn_every, 2 * cfg.attn_every, \
            cfg.num_layers // cfg.attn_every, cfg.attn_every
    return 2, 4, cfg.num_layers, 1


def _reduced(cfg, n_layers: int):
    kw = dict(num_layers=n_layers)
    if cfg.family == "encdec":
        kw["dec_layers"] = n_layers
    return dataclasses.replace(cfg, **kw)


def _measure(cfg, arch: str, shape_name: str, mesh, sp_activations, device):
    """Trace one cell of config `cfg`; returns (flops, bytes, coll_wire,
    coll_by_kind)."""
    fn, args, in_sh, _, _ = build_cell(arch, shape_name, mesh,
                                       sp_activations=sp_activations, cfg=cfg)
    _, counter, _ = measure(fn, args, in_sh, device)
    coll = parse_collectives(counter.collectives)
    return (counter.flops, counter.bytes, coll.wire_bytes,
            {k: tuple(v) for k, v in coll.by_kind.items()})


def calibrate_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                   sp_activations=None, device=None, cfg=None) -> dict:
    """The two-depth extrapolation of one cell's flops, bytes and
    collective wire bytes to the config's depth. `cfg` replaces the
    arch's config (a smoke config in tests)."""
    from repro_torch.device import resolve
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"status": "SKIP", "reason": why}
    dev = resolve(device)
    mesh = production_mesh(multi_pod, dev)
    a, b, full_units, per_unit_layers = _depth_points(cfg)

    fa = _measure(_reduced(cfg, a), arch, shape_name, mesh, sp_activations,
                  dev)
    fb = _measure(_reduced(cfg, b), arch, shape_name, mesh, sp_activations,
                  dev)

    ua, ub = a // per_unit_layers, b // per_unit_layers
    out = {}
    for i, key in enumerate(("flops", "bytes", "coll_wire")):
        per_unit = (fb[i] - fa[i]) / (ub - ua)
        out[key] = fa[i] + per_unit * (full_units - ua)
        out[key + "_per_unit"] = per_unit
    out["points"] = {"a_layers": a, "b_layers": b,
                     "a": {"flops": fa[0], "bytes": fa[1],
                           "coll_wire": fa[2]},
                     "b": {"flops": fb[0], "bytes": fb[1],
                           "coll_wire": fb[2]}}
    out["status"] = "OK"
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default="results/calibration_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the mesh's device type (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.configs import ASSIGNED_ARCHS
    archs = ASSIGNED_ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    multi = args.mesh == "multi"
    tag = "pod2x16x16" if multi else "pod16x16"
    os.makedirs(os.path.join(args.out, tag), exist_ok=True)
    try:
        for arch in archs:
            for shape in shapes:
                path = os.path.join(args.out, tag, f"{arch}__{shape}.json")
                if args.skip_existing and os.path.exists(path):
                    continue
                try:
                    rec = calibrate_cell(arch, shape, multi_pod=multi,
                                         device=args.device)
                except Exception as e:  # noqa: BLE001
                    rec = {"status": "FAIL",
                           "error": f"{type(e).__name__}: {e}"}
                rec.update(arch=arch, shape=shape, mesh=tag)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2)
                st = rec["status"]
                extra = "" if st != "OK" else \
                    f" flops={rec['flops']:.3e} bytes={rec['bytes']:.3e} " \
                    f"coll={rec['coll_wire']:.3e}"
                print(f"[{tag}] {arch} x {shape}: {st}{extra}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
