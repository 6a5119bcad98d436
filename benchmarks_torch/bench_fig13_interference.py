"""Fig. 13: robustness to wireless interference — TTFT under increasing
access-point congestion. SparKV's runtime controller migrates starved
streamed chunks to local compute.

Two congestion models:

  - scalar (default, paper-figure parity): each congestion level is a
    different ``NetworkProfile`` (mean bandwidth down, variance up) fed
    to isolated single-request engines;
  - structural (``--multi-device``): N devices each stream through their
    own NIC stage into one shared AP uplink (two-stage ``LinkTopology``)
    — congestion *emerges* from the fair-shared uplink instead of being
    dialed in, and the per-request uplink-share telemetry shows who got
    starved.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs import SparKVConfig, get_config
from repro_torch.core import baselines as B
from repro_torch.core.costs import NETWORKS
from repro_torch.data.workloads import DATASETS, synthesize

from benchmarks_torch.common import save, table


def _scalar_rows(quick: bool, seeds: int):
    cfg = get_config("sparkv-qwen3-4b")
    spcfg = SparKVConfig()
    wl = synthesize(cfg, 12_288, DATASETS["longchat"])
    rows = []
    nets = ["campus-wifi", "congested-2dev", "congested-5dev"]
    for net_name in nets[:2] if quick else nets:
        net = NETWORKS[net_name]
        agg = {}
        for pol, fn in [("sparkv", B.run_sparkv),
                        ("sparkv_noadapt",
                         lambda *a, **k: B.run_sparkv(*a, adapt=False, **k)),
                        ("strong_hybrid", B.run_strong_hybrid),
                        ("cachegen", B.run_cachegen)]:
            ttfts = [fn(cfg, wl, "jetson-orin", net, spcfg, seed=s).ttft_s
                     for s in range(1 if quick else seeds)]
            agg[pol] = float(np.mean(ttfts))
        rows.append({
            "network": net_name, **{f"{k}_ttft": v for k, v in agg.items()},
            "vs_hybrid_x": agg["strong_hybrid"] / agg["sparkv"],
            "vs_cachegen_x": agg["cachegen"] / agg["sparkv"],
            "adapt_gain_x": agg["sparkv_noadapt"] / agg["sparkv"],
        })
    return rows, "\n[Fig 13] TTFT under wireless interference"


def _multi_device_rows(quick: bool):
    """Structural congestion: n devices, each loading one context through
    its NIC into the shared AP uplink; per-policy fleet TTFT + uplink
    share. The single-device row is the uncongested baseline. Each
    congestion level also runs as the three-hop cloud tree (two APs
    splitting the uplink crowd, one shared cloud-egress stage): the
    second AP relieves the last-metre contention until the egress trunk
    binds — the deeper-topology counterpart of the same study."""
    from repro_torch.serving.cluster import RequestSpec, ServingCluster
    cfg = get_config("sparkv-qwen3-4b")
    spcfg = SparKVConfig(scheduler_mode="engine")
    ctx = 4096 if quick else 8192
    levels = [1, 2] if quick else [1, 2, 5]
    variants = [("two-stage", dict())]
    if not quick:
        variants.append(("three-hop", dict(n_aps=2,
                                           egress="cloud-egress")))
    rows = []
    for n_dev in levels:
        for topo, kw in (variants if n_dev > 1 else variants[:1]):
            row = {"n_devices": n_dev, "topology": topo}
            for pol in ("sparkv", "strong_hybrid", "cachegen"):
                specs = [RequestSpec(arrival_s=0.0, context_len=ctx,
                                     policy=pol, seed=i, device=i)
                         for i in range(n_dev)]
                rep = ServingCluster(cfg, spcfg, "jetson-orin",
                                     "campus-wifi",
                                     max_concurrency=n_dev,
                                     n_devices=n_dev, nic="device-nic",
                                     **kw).run(specs)
                s = rep.summary()
                row[f"{pol}_ttft"] = s["ttft_mean_s"]
                row[f"{pol}_share"] = s["uplink_share_p50"]
            row["vs_hybrid_x"] = row["strong_hybrid_ttft"] \
                / row["sparkv_ttft"]
            row["vs_cachegen_x"] = row["cachegen_ttft"] \
                / row["sparkv_ttft"]
            rows.append(row)
    return rows, ("\n[Fig 13] TTFT under AP congestion "
                  "(NIC -> uplink tree, and the three-hop cloud variant)")


def run(quick: bool = False, seeds: int = 3, multi_device: bool = False):
    if multi_device:
        rows, title = _multi_device_rows(quick)
    else:
        rows, title = _scalar_rows(quick, seeds)
    print(table(rows, list(rows[0].keys()), title=title))
    save("fig13_interference" + ("_multi_device" if multi_device else ""),
         {"rows": rows}, quick=quick)
    return rows


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--multi-device", action="store_true")
    a = ap.parse_args()
    run(quick=a.quick, multi_device=a.multi_device)
