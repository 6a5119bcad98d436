"""KV memory server: goodput under finite device memory budgets.

Through PR 5 device memory was infinite — long-decode overloads kept
every assembled context resident forever, so fleet goodput was blind to
the resource that binds first on real devices. This bench arms the
:class:`repro.serving.memory.KVMemoryServer` on a long-decode sparkv
overload and measures what finiteness actually costs:

  - **budget sweep** — one unbounded tracking run measures the workload's
    true peak residency, then the same trace replays under budgets at
    fractions of that peak: goodput-vs-memory-budget curves;
  - **eviction policies** — at each budget, ``lru`` / ``idle`` /
    ``bits`` (evict-to-lower-bits requantizes the victim in place down
    the quantization ladder instead of suspending it);
  - **reload modes** — the overhead-aware ``planner`` (per chunk, pick
    among disk read / cloud restream / local recompute, seeded with the
    live backlogs) against the single-path ``restream`` and
    ``recompute`` baselines.

Acceptance: at every finite budget the planner's goodput beats *both*
single-path reload baselines — reload time is SparKV's stream-vs-compute
decision re-posed at eviction time, and picking one path in advance
loses to picking per chunk against live contention.
"""
from __future__ import annotations

from repro_torch.configs import SparKVConfig, get_config
from repro_torch.core.costs import MemoryModel, RunQueueModel
from repro_torch.serving.cluster import ServingCluster
from repro_torch.serving.decode import DecodeConfig
from repro_torch.serving.traffic import TrafficProfile, generate_trace

from benchmarks_torch.common import save, table

# long responses: decode-phase KV growth, not just prefill residency,
# drives the device over budget
OUT_LEN_MIX = ((192, 0.5), (384, 0.5))

# fractions of the measured unbounded peak residency
BUDGET_FRACS = (0.6, 0.35)

# (label, policy, reload mode)
VARIANTS = [
    ("planner-lru", "lru", "planner"),
    ("planner-idle", "idle", "planner"),
    ("planner-bits", "bits", "planner"),
    ("restream-lru", "lru", "restream"),
    ("recompute-lru", "lru", "recompute"),
]


def _cluster(cfg, spcfg, memory):
    return ServingCluster(cfg, spcfg, "jetson-orin", "campus-wifi",
                          max_concurrency=8,
                          run_queue=RunQueueModel(1, "fifo"),
                          decode=DecodeConfig(max_batch=4),
                          memory=memory)


def _row(label, budget_frac, budget, rep) -> dict:
    s = rep.summary()
    return {
        "config": label,
        "budget_frac": budget_frac,
        "budget_gb": budget / 1e9 if budget is not None else None,
        "tokens_out": s["tokens_out_total"],
        "goodput_tok_s": s["goodput_tok_s"],
        "ttft_p99_s": s["ttft_p99_s"],
        "tpot_p99_s": s["tpot_p99_s"],
        "ttlt_p99_s": s["ttlt_p99_s"],
        "peak_resident_gb": s["peak_resident_bytes"] / 1e9,
        "n_evictions": s["n_evictions"],
        "n_downgrades": s["n_downgrades"],
        "n_reloads": s["n_reloads"],
        "reload_s_total": s["reload_s_total"],
        "makespan_s": rep.makespan_s,
    }


def run(quick: bool = False):
    cfg = get_config("sparkv-qwen3-4b")
    spcfg = SparKVConfig(scheduler_mode="engine")
    n_req = 5 if quick else 12
    prof = TrafficProfile(rate_rps=2.0, arrival="poisson",
                          policy_mix=(("sparkv", 1.0),),
                          max_context=8192, out_len_mix=OUT_LEN_MIX)
    specs = generate_trace(prof, n_req, seed=31)

    # unbounded tracking run: measures true peak residency and anchors
    # the budget sweep; bit-identical to a memory-less cluster
    rep0 = _cluster(cfg, spcfg, MemoryModel(capacity_bytes=None)).run(specs)
    peak = rep0.summary()["peak_resident_bytes"]
    rows = [_row("unbounded", None, None, rep0)]
    print(f"\n[memory] {n_req} Poisson long-decode requests, "
          f"unbounded peak residency {peak / 1e9:.2f} GB")

    acceptance = {}
    for frac in BUDGET_FRACS:
        budget = frac * peak
        for label, policy, mode in VARIANTS:
            rep = _cluster(cfg, spcfg,
                           MemoryModel(capacity_bytes=budget,
                                       policy=policy,
                                       reload=mode)).run(specs)
            rows.append(_row(label, frac, budget, rep))
        sweep = {r["config"]: r["goodput_tok_s"] for r in rows
                 if r["budget_frac"] == frac}
        planner_best = max(sweep[k] for k in
                           ("planner-lru", "planner-idle", "planner-bits"))
        ok = planner_best > sweep["restream-lru"] \
            and planner_best > sweep["recompute-lru"]
        acceptance[f"budget_{frac}"] = {
            "planner_best_tok_s": planner_best,
            "restream_tok_s": sweep["restream-lru"],
            "recompute_tok_s": sweep["recompute-lru"],
            "planner_wins": ok,
        }
        print(f"budget {frac:.2f}x peak: planner {planner_best:.2f} tok/s "
              f"vs restream {sweep['restream-lru']:.2f} / "
              f"recompute {sweep['recompute-lru']:.2f}"
              + ("  [acceptance met]" if ok else ""))

    print(table(rows, list(rows[0].keys()),
                title="\n[memory] goodput vs. memory budget"))
    save("kv_memory",
         {"rows": rows, "acceptance": acceptance,
          "peak_resident_bytes": peak,
          "budget_fracs": list(BUDGET_FRACS),
          "out_len_mix": list(OUT_LEN_MIX)},
         quick=quick)
    return rows


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    a = ap.parse_args()
    run(quick=a.quick)
