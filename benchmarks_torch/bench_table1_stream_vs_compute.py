"""Table I: TTFT and energy, wireless KV streaming vs on-device prefill,
across edge platforms (+ the TPU serving profile)."""
from __future__ import annotations

from repro_torch.configs import SparKVConfig, get_config
from repro_torch.core import baselines as B
from repro_torch.core.costs import NETWORKS
from repro_torch.data.workloads import DATASETS, synthesize

from benchmarks_torch.common import save, table

# (device profile, model, context length) mirroring the paper's rows
ROWS = [
    ("redmi-k80", "sparkv-qwen3-4b", 8_192, "campus-wifi"),
    ("laptop-5080", "sparkv-qwen3-4b", 12_288, "campus-wifi"),
    ("jetson-orin", "qwen2.5-3b", 16_384, "campus-wifi"),
    ("jetson-agx", "phi3-medium-14b", 24_576, "campus-wifi"),
    ("tpu-v5e-1chip", "sparkv-qwen3-4b", 16_384, "dcn-25g"),
]


def run(quick: bool = False):
    spcfg = SparKVConfig()
    rows = []
    for profile, arch, ctx, net_name in ROWS[:3 if quick else None]:
        cfg = get_config(arch)
        wl = synthesize(cfg, ctx, DATASETS["triviaqa"])
        net = NETWORKS[net_name]
        # stream-only at the native 5-bit encoding (Table I measures raw
        # streaming, not CacheGen's bitrate ladder)
        stream = B.run_kivi(cfg, wl, profile, net, spcfg, seed=0,
                            bits=spcfg.quant_bits)
        comp = B.run_local_prefill(cfg, wl, profile, net, spcfg, seed=0)
        rows.append({
            "device": profile, "model": arch, "ctx": ctx,
            "stream_ttft_s": stream.ttft_s, "stream_J": stream.energy_j,
            "compute_ttft_s": comp.ttft_s, "compute_J": comp.energy_j,
            "ttft_gain": comp.ttft_s / stream.ttft_s,
            "energy_gain": comp.energy_j / stream.energy_j,
        })
    print(table(rows, list(rows[0].keys()),
                title="\n[Table I] KV streaming vs on-device prefill"))
    save("table1_stream_vs_compute", {"rows": rows}, quick=quick)
    return rows


if __name__ == "__main__":
    run()
