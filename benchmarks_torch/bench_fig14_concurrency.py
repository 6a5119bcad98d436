"""Fig. 14: concurrent requests — TTFT and energy/request as edge compute
is shared (device utilization rises); SparKV sheds compute-path work to
streaming when the device is contended.

Two utilization sources:

  - static (default, paper-figure parity): each level is a hand-set
    `util` scalar fed to an isolated single-request engine;
  - closed-loop (`closed_loop=True`): each level is N actually-concurrent
    requests in the serving cluster — utilization emerges from in-flight
    compute chunks and the shared link, not from a dial.

The closed-loop mode additionally compares device scheduling disciplines
on the explicit run queue (FIFO vs. WFQ with a weighted interactive class
plus a background bulk load): per-request queue-wait breakdowns and the
p99 TTFT divergence between disciplines under contention.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs import SparKVConfig, get_config
from repro_torch.core import baselines as B
from repro_torch.core.costs import NETWORKS
from repro_torch.data.workloads import DATASETS, synthesize

from benchmarks_torch.common import save, table

POLICIES = ["sparkv", "strong_hybrid", "local_prefill"]


def _row(label, ttft, energy):
    return {
        "concurrency": label,
        "sparkv_ttft": ttft["sparkv"],
        "hybrid_ttft": ttft["strong_hybrid"],
        "local_ttft": ttft["local_prefill"],
        "sparkv_J": energy["sparkv"],
        "hybrid_J": energy["strong_hybrid"],
        "local_J": energy["local_prefill"],
        "vs_hybrid_x": ttft["strong_hybrid"] / ttft["sparkv"],
        "vs_local_x": ttft["local_prefill"] / ttft["sparkv"],
    }


def _static_rows(cfg, spcfg, wl, net, levels):
    rows = []
    for util in levels:
        ttft, energy = {}, {}
        for pol in POLICIES:
            r = B.PIPELINES[pol](cfg, wl, "jetson-orin", net, spcfg,
                                 util=util, seed=0)
            ttft[pol], energy[pol] = r.ttft_s, r.energy_j
        rows.append(_row(util, ttft, energy))
    return rows


def _closed_loop_rows(cfg, context_len, levels_n):
    """Utilization from N genuinely-concurrent requests in the cluster."""
    from repro_torch.serving.cluster import RequestSpec, ServingCluster
    spcfg = SparKVConfig(scheduler_mode="engine")
    rows = []
    for n in levels_n:
        ttft, energy = {}, {}
        for pol in POLICIES:
            specs = [RequestSpec(arrival_s=0.0, context_len=context_len,
                                 policy=pol, seed=i) for i in range(n)]
            rep = ServingCluster(cfg, spcfg, "jetson-orin", "campus-wifi",
                                 max_concurrency=n, closed_loop=True
                                 ).run(specs)
            s = rep.summary()
            ttft[pol] = s["ttft_mean_s"]
            energy[pol] = s["energy_per_req_j"]
        rows.append(_row(f"N={n}", ttft, energy))
    return rows


def _discipline_rows(cfg, context_len, n_interactive):
    """FIFO vs. WFQ vs. SRPT on the explicit capacity-1 run queue: one
    background bulk load (weight 1, no deadline) + n weighted interactive
    requests (weight 8, TTFT deadline so SRPT's anti-starvation floor is
    armed), all sparkv so queue telemetry also drives migrations. Same
    offered load for every discipline — the interactive-class p99 TTFT
    column is the comparison the SLO layer exists for."""
    from repro_torch.core.costs import RunQueueModel
    from repro_torch.serving.cluster import RequestSpec, ServingCluster
    spcfg = SparKVConfig(scheduler_mode="engine")
    specs = [RequestSpec(arrival_s=0.0, context_len=2 * context_len,
                         policy="sparkv", seed=0, weight=1.0)]
    specs += [RequestSpec(arrival_s=0.3 * i, context_len=context_len,
                          policy="sparkv", seed=i, weight=8.0,
                          deadline_s=4.0, slo_class="interactive")
              for i in range(1, n_interactive + 1)]
    rows = []
    for disc in ("fifo", "wfq", "srpt"):
        rep = ServingCluster(cfg, spcfg, "jetson-orin", "campus-wifi",
                             max_concurrency=len(specs),
                             run_queue=RunQueueModel(1, disc)).run(specs)
        s = rep.summary()
        shorts = [r.ttft_s for r in rep.records if r.spec.weight > 1]
        rows.append({
            "discipline": disc,
            "ttft_p50_s": s["ttft_p50_s"],
            "ttft_p99_s": s["ttft_p99_s"],
            "interactive_p99_s": float(np.percentile(shorts, 99)),
            "interactive_attainment": s["slo_attainment"],
            "queue_wait_p50_s": s["queue_wait_p50_s"],
            "queue_wait_p99_s": s["queue_wait_p99_s"],
            "migrations": s["migrations_total"],
        })
    return rows


def run(quick: bool = False, closed_loop: bool = False):
    cfg = get_config("sparkv-qwen3-4b")
    net = NETWORKS["campus-wifi"]
    rows = []
    if closed_loop:
        levels_n = [1, 2] if quick else [1, 2, 4, 8]
        ctx = 4096 if quick else 8192
        rows = _closed_loop_rows(cfg, ctx, levels_n)
        title = "\n[Fig 14] concurrent-request contention (closed-loop N)"
        disc_rows = _discipline_rows(cfg, 2048, 3 if quick else 5)
        print(table(disc_rows, list(disc_rows[0].keys()),
                    title="\n[Fig 14b] run-queue discipline: FIFO vs WFQ "
                          "vs SRPT (background + deadline interactive)"))
        p99 = {r["discipline"]: r["ttft_p99_s"] for r in disc_rows}
        print(f"p99 TTFT divergence fifo vs wfq: "
              f"{abs(p99['fifo'] - p99['wfq']) / max(p99['fifo'], p99['wfq']):.1%}")
        ip99 = {r["discipline"]: r["interactive_p99_s"] for r in disc_rows}
        best = min(("wfq", "srpt"), key=lambda d: ip99[d])
        delta = 1 - ip99[best] / ip99["fifo"]
        word = "better" if delta >= 0 else "worse"
        print(f"interactive p99: fifo {ip99['fifo']:.3f}s -> {best} "
              f"{ip99[best]:.3f}s ({abs(delta):.1%} {word})")
    else:
        disc_rows = []
        spcfg = SparKVConfig()
        wl = synthesize(cfg, 12_288, DATASETS["longchat"])
        levels = [0.0, 0.3, 0.6, 0.8]
        rows = _static_rows(cfg, spcfg, wl, net,
                            levels[:2] if quick else levels)
        title = "\n[Fig 14] concurrent-request contention"
    print(table(rows, list(rows[0].keys()), title=title))
    save("fig14_concurrency" + ("_closed_loop" if closed_loop else ""),
         {"rows": rows, "disciplines": disc_rows}, quick=quick)
    return rows


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--closed-loop", action="store_true")
    a = ap.parse_args()
    run(quick=a.quick, closed_loop=a.closed_loop)
