"""Fig. 16: overhead breakdown — streaming path (transmission vs entropy
decode + device transfer) and compute path share, from the engine
timeline of a SparKV run."""
from __future__ import annotations

from repro_torch.configs import SparKVConfig, get_config
from repro_torch.core import baselines as B
from repro_torch.core.costs import NETWORKS
from repro_torch.data.workloads import DATASETS, synthesize

from benchmarks_torch.common import save, table


def run(quick: bool = False):
    cfg = get_config("sparkv-qwen3-4b")
    spcfg = SparKVConfig()
    wl = synthesize(cfg, 11_264, DATASETS["triviaqa"])
    net = NETWORKS["campus-wifi"]
    r = B.run_sparkv(cfg, wl, "laptop-5080", net, spcfg, seed=0)
    eng = r.engine
    bd = eng.breakdown()
    stream_total = eng.stream_busy_s
    rows = [{
        "transmission_s": bd["transmission_s"],
        "decode_proc_s": bd["decode_proc_s"],
        "transmission_pct": 100 * bd["transmission_s"]
        / max(stream_total, 1e-9),
        "decode_pct": 100 * bd["decode_proc_s"] / max(stream_total, 1e-9),
        "compute_s": bd["compute_s"],
        "ttft_s": r.ttft_s,
        "bytes_MB": eng.bytes_streamed / 1e6,
    }]
    print(table(rows, list(rows[0].keys()),
                title="\n[Fig 16] SparKV overhead breakdown "
                      "(laptop, TriviaQA-like)"))
    save("fig16_breakdown", {"rows": rows}, quick=quick)
    return rows


if __name__ == "__main__":
    run()
