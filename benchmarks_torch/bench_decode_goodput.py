"""Continuous batched decode: full-response goodput under overload.

The pre-decode fleet ended every request at its first token, so its
"goodput" silently assumed the decode phase was free. This bench runs
the fig14-style overload scenarios with per-request response lengths and
compares, on identical traffic:

  - ``first-token``  — decode disabled (the old accounting): requests
    drop at TTFT, one token each ever reaches the user;
  - ``serial``       — full responses, but decode batch size 1: whole
    responses serialize on the device;
  - ``continuous``   — full responses through the continuous batcher
    (max_batch 8, token-boundary join/leave): co-resident sequences
    share each decode step's weight reads.

Scenarios:

  - **compute-bound** — sparkv fleet on a capacity-1 device: decode
    steps contend with prefill chunks on the FIFO run queue;
  - **stream-bound** — strong_hybrid fleet on a capacity-2 device: the
    shared link throttles context assembly while decode drains batches.

Acceptance: on both scenarios, continuous batching delivers more
tokens/s than the first-token-only fleet ever shipped *and* than serial
decode — batching, not accounting, buys the throughput.
"""
from __future__ import annotations

from repro_torch.configs import SparKVConfig, get_config
from repro_torch.core.costs import RunQueueModel
from repro_torch.serving.cluster import ServingCluster
from repro_torch.serving.decode import DecodeConfig
from repro_torch.serving.traffic import TrafficProfile, generate_trace

from benchmarks_torch.common import save, table

SCENARIOS = {
    # name: (policy, rate_rps, capacity) — rates chosen well past the
    # device's service rate so responses genuinely pile up (decode
    # overlap is what continuous batching monetizes)
    "compute-bound": ("sparkv", 2.5, 1),
    "stream-bound": ("strong_hybrid", 3.0, 2),
}

# chat-reply / long-generation response mix (tokens)
OUT_LEN_MIX = ((32, 0.5), (128, 0.5))


VARIANTS = [
    ("first-token", None),                       # decode off (old account)
    ("serial", DecodeConfig(max_batch=1)),
    ("continuous", DecodeConfig(max_batch=8)),
]


def _run_scenario(cfg, spcfg, name: str, n_req: int) -> list[dict]:
    import dataclasses
    policy, rate, capacity = SCENARIOS[name]
    prof = TrafficProfile(rate_rps=rate, arrival="poisson",
                          policy_mix=((policy, 1.0),),
                          max_context=8192, out_len_mix=OUT_LEN_MIX)
    specs = generate_trace(prof, n_req, seed=23)
    rows = []
    for label, decode in VARIANTS:
        run_specs = specs if decode is not None else [
            dataclasses.replace(s, max_new_tokens=0) for s in specs]
        rep = ServingCluster(cfg, spcfg, "jetson-orin", "campus-wifi",
                             max_concurrency=6,
                             run_queue=RunQueueModel(capacity, "fifo"),
                             decode=decode).run(run_specs)
        s = rep.summary()
        rows.append({
            "scenario": name,
            "config": label,
            "tokens_out": s["tokens_out_total"],
            "goodput_tok_s": s["goodput_tok_s"],
            "goodput_resp_s": s["goodput_resp_s"],
            "ttft_p99_s": s["ttft_p99_s"],
            "tpot_p50_s": s["tpot_p50_s"],
            "tpot_p99_s": s["tpot_p99_s"],
            "ttlt_p99_s": s["ttlt_p99_s"],
            "energy_per_req_j": s["energy_per_req_j"],
            "makespan_s": rep.makespan_s,
        })
    return rows


def run(quick: bool = False):
    cfg = get_config("sparkv-qwen3-4b")
    spcfg = SparKVConfig(scheduler_mode="engine")
    n_req = 6 if quick else 14
    all_rows = []
    acceptance = {}
    for name in SCENARIOS:
        rows = _run_scenario(cfg, spcfg, name, n_req)
        all_rows.extend(rows)
        print(table(rows, list(rows[0].keys()),
                    title=f"\n[decode] {name}: {n_req} Poisson requests, "
                          f"out-len mix {OUT_LEN_MIX}"))
        tok = {r["config"]: r["goodput_tok_s"] for r in rows}
        ok = tok["continuous"] > tok["first-token"] \
            and tok["continuous"] > tok["serial"]
        acceptance[name] = {
            "first_token_tok_s": tok["first-token"],
            "serial_tok_s": tok["serial"],
            "continuous_tok_s": tok["continuous"],
            "continuous_wins": ok,
        }
        print(f"tokens/s: first-token {tok['first-token']:.2f}, "
              f"serial {tok['serial']:.2f}, "
              f"continuous {tok['continuous']:.2f}"
              + ("  [acceptance met]" if ok else ""))
    save("decode_goodput",
         {"rows": all_rows, "acceptance": acceptance,
          "out_len_mix": list(OUT_LEN_MIX),
          "scenarios": {k: dict(zip(("policy", "rate_rps", "capacity"), v))
                        for k, v in SCENARIOS.items()}},
         quick=quick)
    return all_rows


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    a = ap.parse_args()
    run(quick=a.quick)
