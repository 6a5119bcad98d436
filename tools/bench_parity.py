#!/usr/bin/env python3
"""Run the reference's benchmark harness (``benchmarks/``) and the port's
(``benchmarks_torch/``) bench by bench on the CPU, and print which agree.

  PYTHONPATH=src python tools/bench_parity.py [--only table1,fig3]
      [--full] [--out FILE]

Both harnesses plan through the same planner. Every (config, profile)
planner that either package's ``core/baselines`` cache hands out is one
``FrozenPlanner`` around the port's CPU ``LatencyPredictor``, fit as the
cache fits it (numpy costs, shared by both), and the predictor that fig8
and topology build themselves is the port's CPU predictor in both. So a
last-ulp difference between XLA's and torch's matmuls cannot flip a
greedy choice, and everything downstream is the same numpy code. The
benches that run a model (fig4, quality) run the port's ``measure`` on
the reference's weights (``jax.random.PRNGKey(0)``, converted with
``repro_torch.convert``) against the reference's bench; their numbers
agree within ``TOLERANCES``. Wall-clock fields (``WALL``) are left out of
every comparison. The reference's roofline bench needs
``results/dryrun/``, which the repo does not hold, and fails; the port's
is held to its own H100 terms by tests/test_torch_benchmarks.py.

Prints one line a bench: match, differ (the first differing fields), or
the side that failed, with both harnesses' wall times (host clock).
Exits non-zero unless every bench but roofline matches.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import os
import re
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# keys left out of every comparison: the save stamps, wall-clock times
# (and what is derived from them), and the port's own kv_dequant launch
# counts (quality)
WALL = re.compile(r"^(_time|_device|_profile|kv_dequant_launches|"
                  r"train_s|infer_overhead_ms|"
                  r"greedy_runtime_s|exact_runtime_s|speedup|"
                  r".*ev_per_s|.*wall_s|events_per_s|meets_10x|"
                  r"speedup_at_max_n)$")
# the benches that run a model: per field, the tolerance of the port on
# converted weights (the prefill's bf16 rounding moves a few 5-bit codes)
TOLERANCES = {
    "fig4": {"entropies": ("atol", 0.01), "sizes": ("rtol", 0.005),
             "entropy_min_b": ("atol", 0.01), "entropy_p50_b": ("atol", 0.01),
             "entropy_max_b": ("atol", 0.01), "size_min_KB": ("rtol", 0.005),
             "size_max_KB": ("rtol", 0.005), "size_spread_x": ("rtol", 0.005),
             "vs_raw5bit": ("rtol", 0.005)},
    "quality": {"measured_kl": ("atol", 1e-6)},
}
MODEL_BENCHES = ("fig4", "quality")


class FrozenPlanner:
    """A planner for both packages: the port's CPU predictor's costs as
    numpy arrays."""

    def __init__(self, predictor):
        self.p = predictor
        self.t_dense = predictor.t_dense

    def t_comp_batch(self, *args):
        import numpy as np
        return np.array(self.p.t_comp_batch(*args))


def _port_predictor(cfg, profile, **kw):
    from repro_torch.core.predictor import LatencyPredictor
    return LatencyPredictor(cfg, profile, device="cpu", **kw)


@contextlib.contextmanager
def shared_planner():
    """Both packages' planner caches, and the LatencyPredictor of the
    benches that build their own, on the port's CPU predictor."""
    import benchmarks.bench_fig8_predictor as j8
    import benchmarks.bench_topology_tree as jtop
    import benchmarks_torch.bench_fig8_predictor as t8
    import benchmarks_torch.bench_topology_tree as ttop
    import repro.core.baselines as jb
    import repro_torch.core.baselines as tb
    from repro_torch.core.costs import PROFILES

    planners = {}

    def cache(cfg, profile_name):
        key = (cfg.name, profile_name)
        if key not in planners:
            p = _port_predictor(cfg, PROFILES[profile_name])
            p.fit(4000, epochs=150)
            planners[key] = FrozenPlanner(p)
        return planners[key]

    saved = [(m, a, getattr(m, a)) for m, a in (
        (jb, "_predictor_cache"), (tb, "_predictor_cache"),
        (j8, "LatencyPredictor"), (t8, "LatencyPredictor"),
        (jtop, "LatencyPredictor"), (ttop, "LatencyPredictor"))]
    try:
        jb._predictor_cache = tb._predictor_cache = cache
        for m in (j8, t8, jtop, ttop):
            m.LatencyPredictor = _port_predictor
        yield planners
    finally:
        for m, a, v in saved:
            setattr(m, a, v)


def _modules(name):
    import benchmarks.run as jrun
    import benchmarks_torch.run as trun
    return dict(jrun.BENCHES)[name], dict(trun.BENCHES)[name]


def _load(out_dir):
    files = sorted(Path(out_dir).glob("*.json"))
    return {f.stem: json.loads(f.read_text()) for f in files}


def _run(pkg_common, module, quick, out_dir, *, device=False):
    """One bench of one harness; its saved payloads by name."""
    from repro_torch.device import named
    key = "QUICK_DIR" if quick else "RESULTS_DIR"
    saved = getattr(pkg_common, key)
    setattr(pkg_common, key, out_dir)
    try:
        mod = importlib.import_module(module)
        ctx = named("cpu") if device else contextlib.nullcontext()
        with ctx:
            pkg_common.begin_bench()
            mod.run(quick=quick)
    finally:
        setattr(pkg_common, key, saved)
    return _load(out_dir)


def _run_model_port(name, quick, out_dir):
    """The port's fig4 or quality on the reference's weights, converted;
    saved as its run() saves."""
    import jax
    import numpy as np
    import torch

    import benchmarks_torch.common as tc
    from repro.models import build_model as jbuild
    from repro_torch.convert import convert_params
    from repro_torch.device import named
    _, module = _modules(name)
    mod = importlib.import_module(module)
    cfg, model = mod.smoke_model()
    jparams = jbuild(_reference_cfg(cfg)).init(jax.random.PRNGKey(0))
    params = convert_params(jax.tree.map(np.asarray, jparams), device="cpu")
    cpu = torch.device("cpu")
    key = "QUICK_DIR" if quick else "RESULTS_DIR"
    saved = getattr(tc, key)
    setattr(tc, key, out_dir)
    try:
        with named("cpu"):
            if name == "fig4":
                rows, ents, sizes = mod.measure(model, params, cpu)
                tc.save("fig4_entropy_codesize",
                        {"rows": rows, "entropies": ents.tolist(),
                         "sizes": sizes.tolist()}, quick=quick)
            else:
                rows, launches = mod.measure(model, params, cpu,
                                             quick=quick)
                tc.save("quality_validation",
                        {"rows": rows, "kv_dequant_launches": launches},
                        quick=quick)
    finally:
        setattr(tc, key, saved)
    return _load(out_dir)


def _reference_cfg(cfg):
    """The reference's ModelConfig with the port config's fields."""
    import dataclasses

    from repro.configs import base
    return base.ModelConfig(**{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(cfg)})


def strip(obj):
    """`obj` without the WALL keys, at any depth."""
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items() if not WALL.match(k)}
    if isinstance(obj, list):
        return [strip(v) for v in obj]
    return obj


def differences(a, b, tol=None, path="", key=None):
    """Paths where `b` differs from `a` (beyond `tol`'s entry for the
    field, where it has one)."""
    tol = tol or {}
    if isinstance(a, dict) and isinstance(b, dict):
        out = [f"{path}/{k}: only one side" for k in sorted(set(a) ^ set(b))]
        for k in sorted(set(a) & set(b)):
            out += differences(a[k], b[k], tol, f"{path}/{k}", k)
        return out
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return [f"{path}: {len(a)} vs {len(b)} items"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in differences(x, y, tol, f"{path}[{i}]", key)]
    if (key in tol and isinstance(a, (int, float))
            and isinstance(b, (int, float))):
        kind, t = tol[key]
        bound = t if kind == "atol" else t * abs(a)
        return [] if abs(a - b) <= bound else [f"{path}: {a} vs {b}"]
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) \
            and math.isnan(b):
        return []
    return [] if a == b else [f"{path}: {a!r} vs {b!r}"]


def compare(name, *, quick=True):
    """Run bench `name` in both harnesses; returns a dict with the status
    ("match", "differ", "reference failed", "port failed"), the first
    differences and both wall times."""
    import benchmarks.common as jc
    import benchmarks_torch.common as tc
    jmod, tmod = _modules(name)
    res = {"bench": name}
    with tempfile.TemporaryDirectory() as tmp, shared_planner():
        got = {}
        for side, fn in (
                ("reference", lambda d: _run(jc, jmod, quick, d)),
                ("port", lambda d: (_run_model_port(name, quick, d)
                                    if name in MODEL_BENCHES else
                                    _run(tc, tmod, quick, d, device=True)))):
            out = os.path.join(tmp, side)
            os.makedirs(out)
            t0 = time.perf_counter()
            try:
                got[side] = fn(out)
            except Exception as e:  # noqa: BLE001
                res["status"] = f"{side} failed: {type(e).__name__}: {e}"
            res[f"{side}_s"] = time.perf_counter() - t0
            if "status" in res:
                return res
    diffs = differences(strip(got["reference"]), strip(got["port"]),
                        TOLERANCES.get(name))
    res["status"] = "differ" if diffs else "match"
    res["differences"] = diffs[:5]
    return res


def main(argv=None):
    import benchmarks_torch.run as trun
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only")
    ap.add_argument("--full", action="store_true",
                    help="full runs instead of --quick")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(min(4, torch.get_num_threads()))
    names = [n for n, _ in trun.BENCHES]
    if args.only:
        names = [n for n in names if n in args.only.split(",")]
    t_all = time.perf_counter()
    rows = []
    for name in names:
        rows.append(compare(name, quick=not args.full))
        r = rows[-1]
        walls = ", ".join(f"{s} {r[f'{s}_s']:.1f} s"
                          for s in ("reference", "port") if f"{s}_s" in r)
        print(f"{name:9s} {r['status']} ({walls})"
              + "".join(f"\n    {d}" for d in r.get("differences", [])),
              flush=True)
    wall = time.perf_counter() - t_all
    print(f"{sum(r['status'] == 'match' for r in rows)} of {len(rows)} "
          f"match; {wall:.1f} s wall (host clock)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "wall_s": wall}, f, indent=1)
    bad = [r["bench"] for r in rows if r["status"] != "match"
           and r["bench"] != "roofline"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
