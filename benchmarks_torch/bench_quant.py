"""Per-chunk adaptive quantization: quality-vs-TTFT Pareto under
overload.

Through PR 8 the quantization width was one number per request: the SLO
admission ladder and the memory server's ``bits`` eviction both traded
fidelity *uniformly* — every chunk of a victim paid the same downgrade,
including the handful of hot chunks that carry most of the attention
mass. This bench arms the per-chunk allocation stack end to end and
measures what chunk-granular fidelity buys:

  - **slo-overload Pareto** — a Poisson deadline fleet under moderate
    overload, served by (a) the uniform ladder: one fleet per base width
    in ``BITRATE_LEVELS`` with whole-request admission downgrades, and
    (b) per-chunk arms: a saliency-driven allocation schedule plus
    cold-chunk-only admission downgrades (``SLOPolicy.cold_frac``).
    Each arm reports saliency-weighted quality against TTFT — the
    per-chunk arms sit above the uniform ladder's quality/latency
    frontier;
  - **decode-overload memory** — a long-decode fleet over budget with
    ``bits`` eviction, sweeping ``MemoryModel.cold_frac``: downgrading
    only the cold share of a resident (vs the whole resident) frees
    memory at a smaller fidelity cost;
  - **uniform parity** — the default ``alloc_schedule="uniform"`` fleet
    and the armed-but-neutral ``"flat"`` fleet must report identical
    TTFT/byte traces: the per-chunk machinery is byte-exact when it
    allocates the base width everywhere.

Acceptance: at least one per-chunk arm Pareto-dominates at least one
uniform ladder point (weighted quality >= and p99 TTFT <=, one strict),
and the parity check holds bitwise.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.compression.quantize import BITRATE_LEVELS
from repro_torch.configs import SparKVConfig, get_config
from repro_torch.core.costs import MemoryModel, RunQueueModel
from repro_torch.serving.cluster import ServingCluster
from repro_torch.serving.decode import DecodeConfig
from repro_torch.serving.slo import SLOPolicy
from repro_torch.serving.traffic import TrafficProfile, generate_trace

from benchmarks_torch.common import save, table

# (label, alloc_schedule, base_bits, SLOPolicy kwargs)
PARETO_ARMS = [
    *[(f"uniform@{b}", "flat", b, {}) for b in BITRATE_LEVELS],
    ("perchunk-att@5", "attention", 5, {"cold_frac": 0.6}),
    ("perchunk-agg@6", "aggressive", 6, {"cold_frac": 0.6}),
]

MEM_COLD_FRACS = (1.0, 0.5, 0.3)     # 1.0 = legacy whole-resident


def _spcfg(schedule: str, bits: int) -> SparKVConfig:
    return dataclasses.replace(SparKVConfig(scheduler_mode="engine"),
                               alloc_schedule=schedule, quant_bits=bits)


def _slo_specs(n_req: int):
    prof = TrafficProfile(rate_rps=1.1, arrival="poisson",
                          policy_mix=(("sparkv", 1.0),),
                          max_context=8192,
                          slo_mix=(("interactive", 6.0, 0.7),
                                   ("batch", None, 0.3)))
    return generate_trace(prof, n_req, seed=23)


def _slo_fleet(cfg, spcfg, specs, slo):
    return ServingCluster(cfg, spcfg, "jetson-orin", "campus-wifi",
                          max_concurrency=6,
                          run_queue=RunQueueModel(1, "fifo"),
                          slo=slo).run(specs)


def _pareto_row(label, base_bits, rep) -> dict:
    s = rep.summary()
    qs = [r.quality for r in rep.records]
    return {
        "config": label,
        "base_bits": base_bits,
        "quality_mean": float(np.mean(qs)) if qs else None,
        "quality_min": float(min(qs)) if qs else None,
        "ttft_p99_s": s["ttft_p99_s"],
        "ttft_mean_s": s["ttft_mean_s"],
        "slo_attainment": s["slo_attainment"],
        "bytes_streamed_gb": sum(r.bytes_streamed
                                 for r in rep.records) / 1e9,
        "n_served": s["n_done"],
        "n_shed": s["n_shed"],
        "n_downgraded": s["n_downgraded"],
    }


def _dominates(a: dict, b: dict) -> bool:
    """Pareto dominance on (quality up, p99 TTFT down)."""
    if a["quality_mean"] is None or b["quality_mean"] is None:
        return False
    ge_q = a["quality_mean"] >= b["quality_mean"] - 1e-12
    le_t = a["ttft_p99_s"] <= b["ttft_p99_s"] + 1e-12
    strict = (a["quality_mean"] > b["quality_mean"] + 1e-9
              or a["ttft_p99_s"] < b["ttft_p99_s"] - 1e-9)
    return ge_q and le_t and strict


def _run_pareto(cfg, n_req: int):
    specs = _slo_specs(n_req)
    rows = []
    for label, schedule, bits, slo_kw in PARETO_ARMS:
        rep = _slo_fleet(cfg, _spcfg(schedule, bits), specs,
                         SLOPolicy(**slo_kw))
        rows.append(_pareto_row(label, bits, rep))
    uniform = [r for r in rows if r["config"].startswith("uniform")]
    perchunk = [r for r in rows if r["config"].startswith("perchunk")]
    wins = {p["config"]: [u["config"] for u in uniform
                          if _dominates(p, u)] for p in perchunk}
    return rows, wins


def _run_parity(cfg, n_req: int) -> dict:
    """uniform (disarmed) vs flat (armed, neutral): bitwise trace
    equality is the guarantee that the per-chunk stack costs nothing
    when it isn't asked for anything."""
    specs = _slo_specs(n_req)
    ru = _slo_fleet(cfg, _spcfg("uniform", 5), specs, SLOPolicy())
    rf = _slo_fleet(cfg, _spcfg("flat", 5), specs, SLOPolicy())
    ok = (len(ru.records) == len(rf.records)
          and all(a.ttft_s == b.ttft_s
                  and a.bytes_streamed == b.bytes_streamed
                  and a.energy_j == b.energy_j
                  for a, b in zip(ru.records, rf.records)))
    return {"bitwise_equal": ok, "n_records": len(ru.records)}


def _run_memory(cfg, n_req: int):
    spcfg = _spcfg("uniform", 5)
    prof = TrafficProfile(rate_rps=2.0, arrival="poisson",
                          policy_mix=(("sparkv", 1.0),),
                          max_context=8192,
                          out_len_mix=((192, 0.5), (384, 0.5)))
    specs = generate_trace(prof, n_req, seed=31)

    def cl(memory):
        return ServingCluster(cfg, spcfg, "jetson-orin", "campus-wifi",
                              max_concurrency=8,
                              run_queue=RunQueueModel(1, "fifo"),
                              decode=DecodeConfig(max_batch=4),
                              memory=memory)

    peak = cl(MemoryModel(capacity_bytes=None)).run(specs) \
        .summary()["peak_resident_bytes"]
    # moderate pressure: deep budgets (<0.5x peak) push every resident
    # to the ladder floor regardless of pooling, masking what the cold
    # split preserves
    budget = 0.6 * peak
    rows = []
    for frac in MEM_COLD_FRACS:
        rep = cl(MemoryModel(capacity_bytes=budget, policy="bits",
                             cold_frac=frac)).run(specs)
        s = rep.summary()
        bits = [r.kv_bits for r in rep.records if r.kv_bits > 0]
        rows.append({
            "cold_frac": frac,
            # final resident width of the *hot* pool: cold-share
            # eviction concentrates the fidelity loss on the cold bytes,
            # so the width the decode actually reads stays higher
            "kv_bits_mean": float(np.mean(bits)) if bits else None,
            "goodput_tok_s": s["goodput_tok_s"],
            "tokens_out": s["tokens_out_total"],
            "ttlt_p99_s": s["ttlt_p99_s"],
            "n_evictions": s["n_evictions"],
            "n_downgrades": s["n_downgrades"],
            "n_reloads": s["n_reloads"],
            "reload_s_total": s["reload_s_total"],
        })
    return rows, peak, budget


def run(quick: bool = False):
    cfg = get_config("sparkv-qwen3-4b")
    n_req = 6 if quick else 14

    rows, wins = _run_pareto(cfg, n_req)
    print(table(rows, list(rows[0].keys()),
                title=f"\n[quant] slo-overload Pareto: {n_req} Poisson "
                      f"deadline requests"))
    dominated = sorted({u for us in wins.values() for u in us})
    ok_pareto = bool(dominated)
    for p, us in wins.items():
        print(f"{p} dominates: {', '.join(us) if us else '(none)'}")
    print("pareto acceptance " + ("met" if ok_pareto else "NOT met"))

    parity = _run_parity(cfg, n_req)
    print(f"uniform/flat parity: bitwise_equal={parity['bitwise_equal']} "
          f"over {parity['n_records']} records")

    mem_rows, peak, budget = _run_memory(cfg, max(4, n_req // 2))
    print(table(mem_rows, list(mem_rows[0].keys()),
                title=f"\n[quant] bits-eviction cold_frac sweep "
                      f"(budget {budget / 1e9:.2f} GB = 0.6x peak)"))
    by_frac = {r["cold_frac"]: r for r in mem_rows}
    ok_mem = (by_frac[0.5]["kv_bits_mean"] or 0) >= \
        (by_frac[1.0]["kv_bits_mean"] or 0)
    print(f"cold-pool fidelity: kv_bits {by_frac[1.0]['kv_bits_mean']:.2f}"
          f" (whole) -> {by_frac[0.5]['kv_bits_mean']:.2f} (cold 0.5)"
          + ("  [retained]" if ok_mem else ""))

    save("quant",
         {"rows": rows,
          "pareto": {"wins": wins, "dominated_uniform": dominated,
                     "acceptance_met": ok_pareto},
          "parity": parity,
          "memory": {"rows": mem_rows,
                     "peak_resident_bytes": peak,
                     "budget_bytes": budget,
                     "cold_fracs": list(MEM_COLD_FRACS),
                     "fidelity_retained": ok_mem},
          "arms": [list(a[:3]) for a in PARETO_ARMS]},
         quick=quick)
    return rows


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    a = ap.parse_args()
    run(quick=a.quick)
