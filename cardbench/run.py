"""Benchmark of the PyTorch/CUDA port (``repro_torch``) on one CUDA card.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``. Set-up makes the weights and the traffic from the seed,
registers the contexts and serves one warm-up request; the window then
serves requests in a closed loop for ``--seconds``. With ``--trace 0`` the
result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (the first requests of the window under
``torch.profiler``). After the window the outputs are judged against the
plain reference (``check.py``). The last line of standard output is the
result, as JSON; the numbers compared and their limits are also the last
lines of standard error. Without a card, or with fewer cards than the cell
asks for, it prints no result and exits 2; if JAX or the JAX package is
loaded once the window has closed, it exits 3.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# the script's own folder is no import root: its modules are cardbench.*
_HERE = os.path.dirname(os.path.realpath(__file__))
sys.path[:] = [p for p in sys.path if os.path.realpath(p or ".") != _HERE]

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _paths() -> None:
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    # every build and kernel cache stays in the checkout, at fixed paths:
    # the port's CUDA sources build into build/repro_torch by themselves,
    # and a Triton or torch extension kernel would build here
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    # one process with few threads: the host work is one Python thread,
    # and idle worker pools only take cores from it
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "1"


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _paths()
    import torch
    from cardbench import check, harness
    c = harness.cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cell {c.name} needs {c.chips} CUDA card(s); {n} found",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    torch.zeros(1, device=dev)
    run = harness.Run(c, args.seed, dev, T_START)
    run.setup()
    print(json.dumps({"setup_split_s": run.split}), flush=True)
    run.window(args.seconds, bool(args.trace))
    print(json.dumps({"requests": run.summary()}), flush=True)
    metrics = run.metrics(bool(args.trace))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": c.chips, "memory_peak_bytes": int(run.memory_peak)}
    if args.trace:
        tr = run.trace
        device["busy_s"] = tr["busy_s"] if tr else 0.0
        device["window_s"] = tr["window_s"] if tr else 0.0
    numbers = check.judge(run)
    ok, rows = check.verdict(numbers, c.limits)
    bad = loaded_forbidden()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    result = {"correct": ok and run.failed() == 0,
              "attempted": len(run.requests), "failed": run.failed(),
              "metrics": metrics, "device": device}
    if args.trace and run.trace:
        result["breakdown"] = run.trace["breakdown"]
    result["check"] = rows
    for k, r in rows.items():
        print(f"check {k} {r['value']!r} limit {r['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
