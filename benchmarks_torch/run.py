"""Benchmark harness driver of the PyTorch port: one module per paper
table/figure, the reference's ``benchmarks/run.py`` on ``repro_torch``.

  PYTHONPATH=src python -m benchmarks_torch.run [--quick]
      [--only fig9,fig13] [--profile] [--device cuda|cpu]

``--device`` names where the port runs (default: the card, through
``repro_torch.device.resolve``, which raises without one). It is named
for every bench with ``repro_torch.device.named``, so the modules that
take no device argument (the planner cache of ``core/baselines.py``,
``LatencyPredictor`` built by a bench) run there too; nothing falls back
to the CPU. ``--profile`` stamps a ``_profile`` block into every saved
JSON: the bench's wall-clock plus the simulator-throughput counters
(events, sim wall-clock, events/s) accumulated across its
``ServingCluster.run`` calls. Each bench's wall time (host clock) is
printed in the summary.
"""
from __future__ import annotations

import argparse
import importlib
import time
import traceback

from benchmarks_torch import common

BENCHES = [
    ("table1", "benchmarks_torch.bench_table1_stream_vs_compute"),
    ("table2", "benchmarks_torch.bench_table2_greedy_vs_milp"),
    ("fig3", "benchmarks_torch.bench_fig3_chunk_latency"),
    ("fig4", "benchmarks_torch.bench_fig4_entropy_codesize"),
    ("fig8", "benchmarks_torch.bench_fig8_predictor"),
    ("fig9", "benchmarks_torch.bench_fig9_overall"),
    ("fig13", "benchmarks_torch.bench_fig13_interference"),
    ("fig14", "benchmarks_torch.bench_fig14_concurrency"),
    ("fleet", "benchmarks_torch.bench_fleet_traffic"),
    ("slo", "benchmarks_torch.bench_slo_admission"),
    ("decode", "benchmarks_torch.bench_decode_goodput"),
    ("topology", "benchmarks_torch.bench_topology_tree"),
    ("memory", "benchmarks_torch.bench_kv_memory"),
    ("reuse", "benchmarks_torch.bench_reuse"),
    ("fig15", "benchmarks_torch.bench_fig15_context_scaling"),
    ("fig16", "benchmarks_torch.bench_fig16_breakdown"),
    ("quality", "benchmarks_torch.bench_quality_validation"),
    ("roofline", "benchmarks_torch.bench_roofline"),
    ("simcore", "benchmarks_torch.bench_simcore"),
    ("quant", "benchmarks_torch.bench_quant"),
    ("hostile", "benchmarks_torch.bench_hostile"),
]


def main(argv=None):
    from repro_torch.device import named

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None)
    ap.add_argument("--profile", action="store_true",
                    help="stamp wall-clock + simulator events/s metadata "
                         "into every saved bench JSON")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card; raises without one) "
                         "or cpu")
    args = ap.parse_args(argv)
    common.PROFILE = args.profile
    only = set(args.only.split(",")) if args.only else None
    known = [name for name, _ in BENCHES]
    if only:
        unknown = sorted(only - set(known))
        if unknown:
            raise SystemExit(
                f"unknown benchmark name(s) in --only: {', '.join(unknown)}"
                f"; registered: {', '.join(known)}")

    t_all = time.time()
    results = {}
    with named(args.device):
        print(f"device: {common.device_name()}", flush=True)
        for name, module in BENCHES:
            if only and name not in only:
                continue
            t0 = time.time()
            try:
                mod = importlib.import_module(module)
                common.begin_bench()
                mod.run(quick=args.quick)
                results[name] = f"OK ({time.time() - t0:.1f}s)"
            except Exception as e:  # noqa: BLE001
                traceback.print_exc()
                results[name] = f"FAIL: {type(e).__name__}: {e}"
    print(f"\n=== benchmark summary ({time.time() - t_all:.1f}s) ===")
    if not results:
        raise SystemExit(f"no benchmarks matched --only={args.only}; "
                         f"known: {', '.join(known)}")
    width = max(len(k) for k in results)
    failed = 0
    for k, v in results.items():
        print(f"  {k.ljust(width)}  {v}")
        failed += v.startswith("FAIL")
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
