"""Figs. 9-12: overall TTFT + response quality, SparKV vs baselines.

Fig. 9: across datasets on the laptop profile (Llama-class model);
Fig. 10: Jetson AGX; Fig. 11: across LLM scales; Fig. 12: VLM workloads
(videomme — higher chunk heterogeneity). Select with `scenario`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs import SparKVConfig, get_config
from repro_torch.core import baselines as B
from repro_torch.core.costs import NETWORKS
from repro_torch.data.workloads import DATASETS, synthesize

from benchmarks_torch.common import save, table

SCENARIOS = {
    "fig9_laptop": {
        "profile": "laptop-5080", "arch": "phi3-medium-14b",
        "datasets": ["repobench-p", "hotpotqa", "triviaqa", "longchat",
                     "govreport", "narrativeqa"],
    },
    "fig10_jetson": {
        "profile": "jetson-agx", "arch": "phi3-medium-14b",
        "datasets": ["triviaqa", "longchat", "narrativeqa"],
    },
    "fig11_llms": {
        "profile": "laptop-5080", "arch": None,   # sweeps archs
        "datasets": ["hotpotqa"],
        "archs": ["sparkv-qwen3-4b", "phi3-medium-14b"],
    },
    "fig12_vlms": {
        "profile": "laptop-5080", "arch": "sparkv-qwen3-4b",
        "datasets": ["videomme"],
    },
}

POLICIES = ["sparkv", "strong_hybrid", "cachegen", "local_prefill"]


def run(quick: bool = False, scenario: str = "fig9_laptop",
        seeds: int = 2):
    sc = SCENARIOS[scenario]
    spcfg = SparKVConfig()
    net = NETWORKS["wifi6-cloud"]
    archs = sc.get("archs") or [sc["arch"]]
    datasets = sc["datasets"][:3] if quick else sc["datasets"]
    rows = []
    for arch in archs:
        cfg = get_config(arch)
        for ds in datasets:
            prof_ds = DATASETS[ds]
            ctx = min(prof_ds.mean_len, 16_384) // 1024 * 1024
            res = {}
            for pol in POLICIES:
                ttfts, es, qs = [], [], []
                for s in range(1 if quick else seeds):
                    wl = synthesize(cfg, ctx, prof_ds,
                                    rng=np.random.default_rng(
                                        prof_ds.seed * 131 + s))
                    r = B.PIPELINES[pol](cfg, wl, sc["profile"], net,
                                         spcfg, seed=s)
                    ttfts.append(r.ttft_s)
                    es.append(r.energy_j)
                    qs.append(r.quality)
                res[pol] = (np.mean(ttfts), np.mean(es), np.mean(qs))
            row = {"arch": arch, "dataset": ds, "ctx": ctx}
            for pol in POLICIES:
                row[f"{pol}_ttft"] = res[pol][0]
                row[f"{pol}_q"] = res[pol][2]
            row["vs_hybrid_x"] = res["strong_hybrid"][0] / res["sparkv"][0]
            row["vs_cachegen_x"] = res["cachegen"][0] / res["sparkv"][0]
            row["vs_local_x"] = res["local_prefill"][0] / res["sparkv"][0]
            rows.append(row)
    cols = (["arch", "dataset", "ctx"]
            + [f"{p}_ttft" for p in POLICIES]
            + ["sparkv_q", "cachegen_q",
               "vs_hybrid_x", "vs_cachegen_x", "vs_local_x"])
    print(table(rows, cols,
                title=f"\n[{scenario}] TTFT (s) + quality, "
                      f"SparKV vs baselines"))
    save(scenario, {"rows": rows}, quick=quick)
    return rows


if __name__ == "__main__":
    import sys
    for sc in (sys.argv[1:] or ["fig9_laptop"]):
        run(scenario=sc)
