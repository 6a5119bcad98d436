"""Fig. 15: TTFT scaling with reusable-context length (10K-38K tokens):
SparKV near-linear; local prefill super-linear; CacheGen bandwidth-bound."""
from __future__ import annotations

from repro_torch.configs import SparKVConfig, get_config
from repro_torch.core import baselines as B
from repro_torch.core.costs import NETWORKS
from repro_torch.data.workloads import DATASETS, synthesize

from benchmarks_torch.common import save, table


def run(quick: bool = False):
    cfg = get_config("sparkv-qwen3-4b")
    spcfg = SparKVConfig()
    net = NETWORKS["campus-wifi"]
    rows = []
    lens = [10_240, 18_432, 28_672, 38_912]
    for ctx in lens[:2] if quick else lens:
        wl = synthesize(cfg, ctx, DATASETS["narrativeqa"])
        row = {"ctx_tokens": ctx}
        for pol in ["sparkv", "strong_hybrid", "cachegen",
                    "local_prefill"]:
            r = B.PIPELINES[pol](cfg, wl, "jetson-agx", net, spcfg, seed=0)
            row[f"{pol}_ttft"] = r.ttft_s
        rows.append(row)
    # scaling exponents (log-log slope first->last)
    import numpy as np
    for pol in ["sparkv", "local_prefill"]:
        y = [r[f"{pol}_ttft"] for r in rows]
        x = [r["ctx_tokens"] for r in rows]
        slope = float(np.polyfit(np.log(x), np.log(y), 1)[0])
        print(f"  {pol} TTFT ~ ctx^{slope:.2f}")
    print(table(rows, list(rows[0].keys()),
                title="\n[Fig 15] TTFT vs reusable-context length "
                      "(jetson-agx)"))
    save("fig15_context_scaling", {"rows": rows}, quick=quick)
    return rows


if __name__ == "__main__":
    run()
