"""Example: SparKV's runtime controller under bandwidth volatility.

Loads the same reusable context across increasingly congested wireless
conditions (the paper's Fig. 13 scenario) and shows how the adaptive
controller migrates chunks from the starved streaming path to local
compute, holding TTFT roughly flat while static schedules degrade.

  PYTHONPATH=src python examples/serve_under_volatility.py
"""

from repro_torch.configs import SparKVConfig, get_config
from repro_torch.core import baselines as B
from repro_torch.core.costs import NETWORKS
from repro_torch.data.workloads import DATASETS, synthesize

cfg = get_config("sparkv-qwen3-4b")
spcfg = SparKVConfig()
wl = synthesize(cfg, 12_000, DATASETS["longchat"])

print(f"workload: {wl.context_len} tokens, {wl.n_t}x{wl.n_l}x{wl.n_h} "
      f"chunks, {wl.total_bytes() / 1e6:.0f} MB compressed")
print(f"{'network':18s} {'sparkv':>10s} {'sparkv(-adapt)':>14s} "
      f"{'strong_hybrid':>14s} {'cachegen':>10s}")

for net_name in ("campus-wifi", "congested-2dev", "congested-5dev"):
    net = NETWORKS[net_name]
    row = []
    r = B.run_sparkv(cfg, wl, "jetson-orin", net, spcfg, seed=1)
    row.append(f"{r.ttft_s:9.2f}s")
    r_na = B.run_sparkv(cfg, wl, "jetson-orin", net, spcfg, seed=1,
                        adapt=False)
    row.append(f"{r_na.ttft_s:13.2f}s")
    r_sh = B.run_strong_hybrid(cfg, wl, "jetson-orin", net, spcfg, seed=1)
    row.append(f"{r_sh.ttft_s:13.2f}s")
    r_cg = B.run_cachegen(cfg, wl, "jetson-orin", net, spcfg, seed=1)
    row.append(f"{r_cg.ttft_s:9.2f}s")
    print(f"{net_name:18s} {' '.join(row)}  "
          f"(migrations: {r.extras.get('migrations', 0)})")
