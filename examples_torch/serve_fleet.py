"""Example: a fleet of concurrent context loads on one shared link.

Generates a bursty arrival trace with a mixed policy population, runs it
through the multi-request serving cluster, and prints per-request and
fleet metrics. Three device-contention models over the same trace:

  - closed-loop: in-flight compute dilates everyone's service time;
  - static util=0: contention coupling off (what single-request modeling
    hides);
  - WFQ run queue: compute *waits* in an explicit weighted-fair device
    queue instead of dilating — queue-wait shows up in the breakdown;
  - SRPT + SLO: deadline-aware admission (predicted TTFT violations are
    downgraded to coarser quant bits or shed) on the preemptive
    shortest-remaining-first queue — attainment and shed counts appear
    in the summary.

  PYTHONPATH=src python examples/serve_fleet.py
"""
from repro_torch.configs import SparKVConfig, get_config
from repro_torch.core.costs import RunQueueModel
from repro_torch.serving.cluster import ServingCluster
from repro_torch.serving.slo import SLOPolicy
from repro_torch.serving.traffic import TrafficProfile, generate_trace

cfg = get_config("sparkv-qwen3-4b")
spcfg = SparKVConfig(scheduler_mode="engine")

profile = TrafficProfile(
    rate_rps=0.8, arrival="bursty", burst_factor=6.0,
    context_mix=(("longchat", 0.6), ("triviaqa", 0.4)),
    policy_mix=(("sparkv", 0.6), ("strong_hybrid", 0.25),
                ("local_prefill", 0.15)),
    max_context=8192,
    # 60% of requests are interactive with an 8 s TTFT SLO; the rest are
    # best-effort batch (deadlines only bind in the SLO-armed mode below)
    slo_mix=(("interactive", 8.0, 0.6), ("batch", None, 0.4)))
specs = generate_trace(profile, 10, seed=42)
print(f"trace: {len(specs)} requests over "
      f"{specs[-1].arrival_s:.1f}s (bursty), contexts "
      f"{min(s.context_len for s in specs)}-"
      f"{max(s.context_len for s in specs)} tokens")

for mode, kw in [("closed-loop", dict(closed_loop=True)),
                 ("static u=0 ", dict(closed_loop=False, static_util=0.0)),
                 ("wfq queue  ", dict(run_queue=RunQueueModel(2, "wfq"))),
                 ("srpt + slo ", dict(run_queue=RunQueueModel(2, "srpt"),
                                      slo=SLOPolicy()))]:
    cluster = ServingCluster(cfg, spcfg, "jetson-orin", "campus-wifi",
                             max_concurrency=4, **kw)
    rep = cluster.run(specs)
    s = rep.summary()
    print(f"\n[{mode}] p50 TTFT {s['ttft_p50_s']:.2f}s  "
          f"p99 {s['ttft_p99_s']:.2f}s  goodput {s['goodput_rps']:.2f} "
          f"req/s  {s['energy_per_req_j']:.0f} J/req  "
          f"{s['migrations_total']} migrations  "
          f"queue-wait p99 {s['queue_wait_p99_s']:.2f}s")
    if kw.get("slo") is not None and s["slo_attainment"] is not None:
        print(f"             SLO attainment {s['slo_attainment']:.0%}  "
              f"shed {s['n_shed']}  downgraded {s['n_downgraded']}  "
              f"goodput-under-SLO {s['goodput_slo_rps']:.2f} req/s")
    if mode == "closed-loop":
        print(f"{'rid':>3} {'policy':15s} {'arr':>6} {'queue':>6} "
              f"{'ttft':>7} {'str/cmp':>8} {'migr':>4}")
        for r in rep.records:
            print(f"{r.rid:>3} {r.policy:15s} {r.spec.arrival_s:6.2f} "
                  f"{r.queue_s:6.2f} {r.ttft_s:6.2f}s "
                  f"{r.n_streamed:>4}/{r.n_computed:<3} "
                  f"{r.n_migrations:>4}")
