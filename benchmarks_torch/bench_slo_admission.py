"""SLO-aware admission & scheduling: attainment under overload.

Two fleet scenarios, each a Poisson trace with a 70/30
interactive-with-deadline / best-effort-batch class mix, run under four
serving configurations on the same specs:

  - ``fifo``       — the PR 2 baseline: non-preemptive FIFO device
    queue, no admission control (every request is served, deadlines are
    recorded but ignored);
  - ``fifo+shed``  — FIFO queue + the SLO admission layer (predicted
    TTFT violations downgrade the KV stream to coarser quantization or
    shed the request);
  - ``wfq+shed``   — SLO admission + deadline-slack-derived WFQ weight
    classes on the device queue;
  - ``srpt+shed``  — SLO admission + the preemptive-at-chunk-boundary
    SRPT discipline with its deadline floor.

Scenarios:

  - **compute-bound** — sparkv fleet on a capacity-1 device: queueing
    delay dominates, shedding is the main lever;
  - **stream-bound** — strong_hybrid fleet on a capacity-2 device: the
    shared link dominates, so the quantization downgrade ladder carries
    part of the load before shedding kicks in.

Reported per configuration: SLO attainment over served deadline-class
requests (the acceptance bar: FIFO < 90%, SLO-enabled >= 90%),
interactive-class p99 TTFT, shed / downgrade counts, and
goodput-under-SLO (only in-contract completions count).
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs import SparKVConfig, get_config
from repro_torch.core.costs import RunQueueModel
from repro_torch.serving.cluster import ServingCluster
from repro_torch.serving.slo import SLOPolicy
from repro_torch.serving.traffic import TrafficProfile, generate_trace

from benchmarks_torch.common import save, table

SCENARIOS = {
    # name: (policy, rate_rps, deadline_s, capacity)
    "compute-bound": ("sparkv", 0.7, 8.0, 1),
    "stream-bound": ("strong_hybrid", 0.9, 10.0, 2),
}


def _variants(capacity: int):
    return [
        ("fifo", RunQueueModel(capacity, "fifo"), None),
        ("fifo+shed", RunQueueModel(capacity, "fifo"), SLOPolicy()),
        ("wfq+shed", RunQueueModel(capacity, "wfq"), SLOPolicy()),
        ("srpt+shed", RunQueueModel(capacity, "srpt"), SLOPolicy()),
    ]


def _run_scenario(cfg, spcfg, name: str, n_req: int) -> list[dict]:
    policy, rate, deadline, capacity = SCENARIOS[name]
    prof = TrafficProfile(rate_rps=rate, arrival="poisson",
                          policy_mix=((policy, 1.0),),
                          max_context=8192,
                          slo_mix=(("interactive", deadline, 0.7),
                                   ("batch", None, 0.3)))
    specs = generate_trace(prof, n_req, seed=11)
    rows = []
    for label, run_queue, slo in _variants(capacity):
        rep = ServingCluster(cfg, spcfg, "jetson-orin", "campus-wifi",
                             max_concurrency=6, run_queue=run_queue,
                             slo=slo).run(specs)
        s = rep.summary()
        ints = [r.ttft_s for r in rep.records if r.deadline_s is not None]
        rows.append({
            "scenario": name,
            "config": label,
            "slo_attainment": s["slo_attainment"],
            # shed requests counted as misses: shows how much of the
            # headline attainment is scheduling gain vs. admission
            # selectivity
            "attainment_arrived": s["slo_attainment_arrived"],
            "interactive_p99_s": float(np.percentile(ints, 99))
            if ints else None,
            "n_served": s["n_done"],
            "n_shed": s["n_shed"],
            "n_downgraded": s["n_downgraded"],
            "goodput_slo_rps": s["goodput_slo_rps"],
            "ttft_p99_s": s["ttft_p99_s"],
        })
    return rows


def run(quick: bool = False):
    cfg = get_config("sparkv-qwen3-4b")
    spcfg = SparKVConfig(scheduler_mode="engine")
    n_req = 8 if quick else 14
    all_rows = []
    acceptance = {}
    for name in SCENARIOS:
        rows = _run_scenario(cfg, spcfg, name, n_req)
        all_rows.extend(rows)
        print(table(rows, list(rows[0].keys()),
                    title=f"\n[SLO] {name}: {n_req} Poisson requests, "
                          f"70/30 interactive/batch"))
        att = {r["config"]: r["slo_attainment"] for r in rows}
        slo_atts = [v for k, v in att.items()
                    if k != "fifo" and v is not None]
        # None everywhere = every deadline request was shed (extreme
        # overload): report 0 served-in-contract rather than crashing
        best = max(slo_atts) if slo_atts else 0.0
        acceptance[name] = {"fifo": att["fifo"], "best_slo": best}
        fifo_att = att["fifo"] if att["fifo"] is not None else 0.0
        print(f"attainment: fifo {fifo_att:.0%} -> best SLO config "
              f"{best:.0%}"
              + ("  [acceptance met]" if fifo_att < 0.9 <= best
                 else ""))
    save("slo_admission", {"rows": all_rows, "acceptance": acceptance,
                           "scenarios": {k: dict(zip(
                               ("policy", "rate_rps", "deadline_s",
                                "capacity"), v))
                               for k, v in SCENARIOS.items()}},
         quick=quick)
    return all_rows


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    a = ap.parse_args()
    run(quick=a.quick)
