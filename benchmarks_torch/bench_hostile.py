"""Hostile-world wireless serving: handoff storms, outages, churn.

Static placement vs. the fleet-wide LP rebalancer on identical request
traces under three worlds:

  - **calm** — a disarmed ``ScenarioTrace`` on both link cores. The
    acceptance bar is *bit-parity*: fingerprints must equal the
    scenario-free fleet's exactly (the hostile machinery must be free
    when unused), asserted in-bench and again in
    ``tests/test_scenarios.py``.
  - **handoff storm** — every device roams onto AP 0 at staggered
    times during a flash-crowd arrival spike. Static placement piles
    the whole fleet onto one uplink; the
    :class:`~repro.serving.scenarios.FleetRebalancer` re-solves the
    Eq. 1 makespan LP at each event (warm-started basis-to-basis) and
    spreads devices back over the reachable APs. Acceptance: rebalanced
    SLO attainment strictly above static.
  - **outage + churn** — an AP blackout window plus a device failure
    mid-trace: in-flight transfers are lost at the boundary (bytes
    re-enter the backlog via the engine's ``StreamLost`` leg), evicted
    requests re-enter admission on surviving devices.

Reported per row: served/shed counts, SLO attainment, p99 TTFT, the
loss/handoff/rebalance telemetry, and LP warm-start hit counts.
"""
from __future__ import annotations

from repro_torch.configs import SparKVConfig, get_config
from repro_torch.core.costs import RunQueueModel
from repro_torch.serving.cluster import ServingCluster
from repro_torch.serving.scenarios import (ChurnEvent, FleetRebalancer,
                                     OutageWindow, ScenarioTrace,
                                     handoff_storm)
from repro_torch.serving.slo import SLOPolicy
from repro_torch.serving.traffic import TrafficProfile, generate_trace

from benchmarks_torch.common import save, table

N_DEVICES = 4
N_APS = 2


def _fingerprint(report):
    """Per-request observables, exactly as produced (no rounding)."""
    return [(r.spec.arrival_s, r.ttft_s, r.ttlt_s, r.energy_j,
             r.uplink_share, r.compute_wait_s, r.bytes_streamed, r.policy,
             tuple(sorted(r.stage_shares.items())))
            for r in report.records]


def _cluster(cfg, spcfg, *, core="vectorized", scenario=None,
             rebalancer=None):
    return ServingCluster(cfg, spcfg, "jetson-orin", "campus-wifi",
                          n_devices=N_DEVICES, n_aps=N_APS,
                          run_queue=RunQueueModel(2, "wfq"),
                          max_concurrency=8, slo=SLOPolicy(),
                          link_core=core, scenario=scenario,
                          rebalancer=rebalancer)


def _specs(n_req: int, *, flash: bool = False):
    prof = TrafficProfile(
        rate_rps=1.2, arrival="poisson", n_devices=N_DEVICES,
        max_context=8192,
        slo_mix=(("interactive", 3.5, 0.7), ("batch", None, 0.3)),
        flash_crowds=((0.5, 3.0, 4.0),) if flash else ())
    return generate_trace(prof, n_req, seed=11)


def _row(label: str, rep) -> dict:
    s = rep.summary()
    scen = rep.scenario or {}
    return {
        "world": label,
        "n_served": s["n_done"],
        "n_shed": s["n_shed"],
        "slo_attainment": s["slo_attainment"],
        "ttft_p99_s": s["ttft_p99_s"],
        "n_handoffs": scen.get("n_handoffs", 0),
        "n_streams_lost": scen.get("n_streams_lost", 0),
        "bytes_lost": scen.get("bytes_lost", 0.0),
        "n_churned": scen.get("n_churned", 0),
        "n_replaced": scen.get("n_replaced", 0),
        "n_rebalances": scen.get("n_rebalances", 0),
        "lp_warm_hits": scen.get("n_lp_warm_hits", 0),
    }


def run(quick: bool = False):
    cfg = get_config("sparkv-qwen3-4b")
    spcfg = SparKVConfig(scheduler_mode="engine")
    n_req = 10 if quick else 24

    # ---- calm world: disarmed scenario must be bit-identical ----
    calm_specs = _specs(n_req)
    parity = {}
    for core in ("vectorized", "scalar"):
        plain = _cluster(cfg, spcfg, core=core).run(calm_specs)
        disarmed = _cluster(cfg, spcfg, core=core,
                            scenario=ScenarioTrace(),
                            rebalancer=FleetRebalancer()).run(calm_specs)
        parity[core] = _fingerprint(plain) == _fingerprint(disarmed)
        assert parity[core], \
            f"disarmed scenario broke {core} fleet bit-parity"
        assert disarmed.scenario is None, "disarmed run grew telemetry"
    calm_rep = _cluster(cfg, spcfg).run(calm_specs)

    # ---- handoff storm under a flash-crowd arrival spike ----
    storm_specs = _specs(n_req, flash=True)
    storm = ScenarioTrace(handoffs=handoff_storm(
        N_DEVICES, N_APS, t_start_s=0.6, spacing_s=0.25))
    rep_static = _cluster(cfg, spcfg, scenario=storm).run(storm_specs)
    rep_rebal = _cluster(cfg, spcfg, scenario=storm,
                         rebalancer=FleetRebalancer()).run(storm_specs)

    # ---- outage + churn ----
    hostile = ScenarioTrace(
        handoffs=handoff_storm(N_DEVICES, N_APS,
                               t_start_s=1.0, spacing_s=0.4),
        outages=(OutageWindow(ap=0, t_start_s=2.0, t_end_s=6.0),),
        churn=(ChurnEvent(t_s=3.0, device=1),))
    rep_h_static = _cluster(cfg, spcfg, scenario=hostile).run(storm_specs)
    rep_h_rebal = _cluster(cfg, spcfg, scenario=hostile,
                           rebalancer=FleetRebalancer()).run(storm_specs)

    rows = [
        _row("calm", calm_rep),
        _row("storm/static", rep_static),
        _row("storm/rebalanced", rep_rebal),
        _row("outage+churn/static", rep_h_static),
        _row("outage+churn/rebalanced", rep_h_rebal),
    ]
    print(table(rows, list(rows[0].keys()),
                title=f"\n[hostile] {n_req} requests, {N_DEVICES} devices "
                      f"/ {N_APS} APs, WFQ, SLO admission"))

    def att(rep):
        a = rep.summary()["slo_attainment"]
        return a if a is not None else 0.0

    acceptance = {
        "calm_parity_vectorized": parity["vectorized"],
        "calm_parity_scalar": parity["scalar"],
        "storm_attainment_static": att(rep_static),
        "storm_attainment_rebalanced": att(rep_rebal),
        "rebalancer_beats_static": att(rep_rebal) > att(rep_static),
        "hostile_attainment_static": att(rep_h_static),
        "hostile_attainment_rebalanced": att(rep_h_rebal),
        "rebalancer_no_worse_hostile":
            att(rep_h_rebal) >= att(rep_h_static),
    }
    print(f"storm attainment: static {acceptance['storm_attainment_static']:.0%}"
          f" -> rebalanced {acceptance['storm_attainment_rebalanced']:.0%}"
          + ("  [acceptance met]"
             if acceptance["rebalancer_beats_static"] else ""))
    save("hostile", {"rows": rows, "acceptance": acceptance,
                     "config": {"n_requests": n_req,
                                "n_devices": N_DEVICES, "n_aps": N_APS}},
         quick=quick)
    return rows


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    run(quick=ap.parse_args().quick)
