"""Fleet traffic: N concurrent requests under Poisson/bursty arrivals.

Runs the multi-request serving cluster for each policy and reports fleet
metrics: p50/p99 TTFT, goodput, energy per request, migrations, plus the
per-request device queue-wait and uplink-share breakdowns from the
resource-server layer. ``--discipline fifo|wfq`` switches the device
server from the legacy closed-loop dilation to the explicit run queue.
Also checks the regressions the subsystem exists to express:

  - link contention: aggregate per-request stream time under concurrency
    exceeds the single-request stream time;
  - closed-loop contention: migration counts differ from the static-util
    path (the controller reacts to *actual* in-flight compute);
  - discipline sensitivity: FIFO and WFQ fleets report different tails
    for a weighted interactive class.
"""
from __future__ import annotations

from repro_torch.configs import SparKVConfig, get_config
from repro_torch.core.costs import RunQueueModel
from repro_torch.serving.cluster import ServingCluster
from repro_torch.serving.traffic import TrafficProfile, generate_trace

from benchmarks_torch.common import save, table

POLICIES = ["sparkv", "strong_hybrid", "local_prefill"]


def run(quick: bool = False, discipline: str | None = None):
    cfg = get_config("sparkv-qwen3-4b")
    spcfg = SparKVConfig(scheduler_mode="engine")
    n_req = 8 if quick else 16
    rate = 1.0 if quick else 0.8
    max_ctx = 4096 if quick else 8192
    run_queue = RunQueueModel(2, discipline) if discipline else None
    mode = f"run-queue/{discipline}" if discipline else "closed-loop"
    rows = []
    contention = {}
    for policy in POLICIES:
        prof = TrafficProfile(rate_rps=rate, arrival="poisson",
                              context_mix=(("longchat", 1.0),),
                              policy_mix=((policy, 1.0),),
                              max_context=max_ctx,
                              weight_mix=((1.0, 0.5), (8.0, 0.5)))
        specs = generate_trace(prof, n_req, seed=7)
        cluster = ServingCluster(cfg, spcfg, "jetson-orin", "campus-wifi",
                                 max_concurrency=8, closed_loop=True,
                                 run_queue=run_queue)
        rep = cluster.run(specs)
        s = rep.summary()
        # single-request baseline on the same trace for the contention check
        solo = ServingCluster(cfg, spcfg, "jetson-orin", "campus-wifi",
                              max_concurrency=8, closed_loop=True,
                              run_queue=run_queue).run(specs[:1])
        per_req_stream = s["stream_busy_total_s"] / max(s["n_done"], 1)
        contention[policy] = {
            "fleet_stream_per_req_s": per_req_stream,
            "solo_stream_s": solo.records[0].stream_busy_s,
        }
        rows.append({
            "policy": policy,
            "n": s["n_done"],
            "ttft_p50_s": s["ttft_p50_s"],
            "ttft_p99_s": s["ttft_p99_s"],
            "goodput_rps": s["goodput_rps"],
            "J_per_req": s["energy_per_req_j"],
            "migrations": s["migrations_total"],
            "queue_mean_s": s["queue_mean_s"],
            "qwait_p50_s": s["queue_wait_p50_s"],
            "qwait_p99_s": s["queue_wait_p99_s"],
            "uplink_share_p50": s["uplink_share_p50"],
        })
    print(table(rows, list(rows[0].keys()),
                title=f"\n[fleet] {n_req} Poisson requests, shared link + "
                      f"{mode} contention"))

    # closed-loop vs static-util migration comparison (sparkv only)
    prof = TrafficProfile(rate_rps=rate, arrival="poisson",
                          policy_mix=(("sparkv", 1.0),),
                          max_context=max_ctx)
    specs = generate_trace(prof, n_req, seed=7)
    migr = {}
    for mode, kw in [("closed_loop", dict(closed_loop=True)),
                     ("static_util0", dict(closed_loop=False,
                                           static_util=0.0))]:
        rep = ServingCluster(cfg, spcfg, "jetson-orin", "campus-wifi",
                             max_concurrency=8, **kw).run(specs)
        migr[mode] = rep.summary()["migrations_total"]
    print(f"\nmigrations closed-loop={migr['closed_loop']} "
          f"vs static util=0: {migr['static_util0']}")
    for pol, c in contention.items():
        print(f"stream-time {pol}: fleet/req {c['fleet_stream_per_req_s']:.3f}s"
              f" vs solo {c['solo_stream_s']:.3f}s")

    save("fleet_traffic" + (f"_{discipline}" if discipline else ""),
         {"rows": rows, "contention": contention, "migrations": migr},
         quick=quick)
    return rows


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--discipline", choices=("fifo", "wfq"), default=None,
                    help="use the explicit device run queue instead of "
                         "closed-loop utilization coupling")
    a = ap.parse_args()
    run(quick=a.quick, discipline=a.discipline)
