"""Readings the correctness limits are set from, for one cell, in one
process:

    python3 cardbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 40 --control 3 [--out calib.jsonl]

For each seed: set-up and a window as a run makes them, then the numbers
``check.judge`` compares (the program's lower readings); for the first
``--control`` seeds also the control's (the reference in the program's
place in the precisions below the configuration's: the upper readings).
One JSON line a seed and side, with each number's largest and median over
positions. The window has to finish as many requests as a run compares.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.realpath(__file__))
sys.path[:] = [p for p in sys.path if os.path.realpath(p or ".") != _HERE]

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(_HERE).parent
for _p in (ROOT / "src", ROOT):
    sys.path.insert(0, str(_p))


def readings(run, control: bool) -> dict:
    from cardbench import check
    pos: list = []
    tok: list = []
    out = check.judge(run, control=control, positions=pos, tokens=tok)
    err = np.concatenate([e for e, _, _ in pos])
    gap = np.concatenate([g for _, g, _ in pos])
    alt = np.concatenate([a for _, _, a in pos])
    med = float(np.median(err))
    out.update(altered_gap_min=float(alt.min()),
               altered_gap_median=float(np.median(alt)),
               logit_err_max=float(err.max()),
               logit_err_p90=float(np.quantile(err, 0.9)),
               logit_err_tail_share=float(np.mean(err > 2 * med)),
               kv_prefill_max=max(float(e.max()) for e in tok),
               kv_prefill_p90=max(float(e.quantile(0.9)) for e in tok),
               positions=int(err.size), gap_positions=int(gap.size))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from cardbench import harness
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    c = harness.cell(args.workload, ROOT)
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        run = harness.Run(c, seed, dev, time.perf_counter())
        run.setup()
        run.window(args.seconds, False)
        sides = [False] + ([True] if k < args.control else [])
        for control in sides:
            t = time.perf_counter()
            row = {"cell": c.name, "seed": seed,
                   "side": "control" if control else "program",
                   "requests": len(run.requests),
                   "streamed": sorted({r.n_streamed for r in run.requests}),
                   "request_ms": [round(r.issue.ms_to(r.ret))
                                  for r in run.requests],
                   **readings(run, control),
                   "check_s": time.perf_counter() - t,
                   "setup_s": run.setup_s}
            print(json.dumps(row), flush=True)
            if out:
                out.write(json.dumps(row) + "\n")
                out.flush()
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
