"""Three-hop cloud-egress topology: what a deeper tree does to the
stream/compute decision, and what the online predictor refresh buys.

Three studies on the tree link topology (``resources.tree_topology``:
per-device NICs -> per-AP uplinks -> one cloud-egress stage shared by
*all* APs):

  - **egress-starvation** — the same telemetry-driven fleet
    (``telemetry_policy`` picks sparkv vs. local_prefill per admission)
    on the two-stage NIC->uplink tree, a three-hop tree with a
    generously provisioned egress, and a three-hop tree whose egress is
    starved. The CacheGen-style hybrid observation ("Compute Or Load KV
    Cache? Why Not Both?"): an upstream bottleneck shared by all APs
    flips the load/compute decision — the policy mix must shift toward
    local compute as the egress starves.
  - **nic-asymmetry** — symmetric NIC fleets vs. a fast/slow NIC split
    (``nic=[...]`` per device) at round-robin routing, and the same
    asymmetric fleet with traffic skewed toward the fast-NIC devices
    (``TrafficProfile.device_mix``).
  - **predictor-refresh** — SLO admission under bursty overload on the
    starved-egress tree, analytic contention terms
    (``slo.predict_ttft``'s occupancy-dilation fallback) vs. the online
    refresh (``ServingCluster(predictor=..., refresh_every=...)``,
    warmed on one prior epoch of the same traffic under analytic
    admission): the learned wait/share models should admit more
    accurately — higher attainment over served deadline requests
    and/or more in-contract goodput in at least one overload scenario.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs import SparKVConfig, get_config
from repro_torch.core.costs import PROFILES, NetworkProfile, RunQueueModel
from repro_torch.core.predictor import LatencyPredictor
from repro_torch.serving.cluster import ServingCluster, telemetry_policy
from repro_torch.serving.slo import SLOPolicy
from repro_torch.serving.traffic import TrafficProfile, generate_trace

from benchmarks_torch.common import save, table

# a cloud trunk that cannot carry the fleet: well below the aggregate
# NIC/uplink capacity (even a lone flow's projected egress share sits
# under telemetry_policy's 0.4 floor), so the shared third hop is the
# bottleneck the two-stage model cannot see
STARVED_EGRESS = NetworkProfile("egress-starved", 280e6 / 8, 60e6 / 8,
                                corr_tau_s=0.5)
FAST_NIC = NetworkProfile("nic-fast", 900e6 / 8, 70e6 / 8, corr_tau_s=1.5)
SLOW_NIC = NetworkProfile("nic-slow", 280e6 / 8, 40e6 / 8, corr_tau_s=1.5)


def _mean(vals):
    return float(np.mean(vals)) if vals else None


def _egress_starvation_rows(cfg, spcfg, n_req: int) -> list[dict]:
    """Policy-mix shift: two-stage vs three-hop under a starved egress,
    telemetry-driven policy selection on identical traffic."""
    n_dev = 6
    prof = TrafficProfile(rate_rps=1.5, arrival="poisson",
                          policy_mix=(("sparkv", 1.0),),
                          max_context=8192, n_devices=n_dev)
    specs = generate_trace(prof, n_req, seed=23)
    configs = [
        ("two-stage", dict()),
        ("three-hop", dict(n_aps=2, egress="cloud-egress")),
        ("three-hop-starved", dict(n_aps=2, egress=STARVED_EGRESS)),
    ]
    rows = []
    for label, kw in configs:
        rep = ServingCluster(cfg, spcfg, "jetson-orin", "campus-wifi",
                             n_devices=n_dev, nic="device-nic",
                             run_queue=RunQueueModel(2, "fifo"),
                             policy_fn=telemetry_policy,
                             max_concurrency=n_dev, **kw).run(specs)
        s = rep.summary()
        pols = [r.policy for r in rep.records]
        egress = [r.stage_shares.get("egress") for r in rep.records
                  if "egress" in r.stage_shares]
        rows.append({
            "config": label,
            "n_sparkv": pols.count("sparkv"),
            "n_local_prefill": pols.count("local_prefill"),
            "ttft_mean_s": s["ttft_mean_s"],
            "ttft_p99_s": s["ttft_p99_s"],
            "bytes_streamed_MB": sum(r.bytes_streamed
                                     for r in rep.records) / 1e6,
            "uplink_share_p50": s["uplink_share_p50"],
            "egress_share_mean": _mean(egress),
        })
    return rows


def _nic_asymmetry_rows(cfg, spcfg, n_req: int) -> list[dict]:
    """Fast/slow NIC split vs the symmetric fleet, round-robin and
    skewed (device_mix) routing on the same three-hop tree."""
    n_dev = 4
    asym = [FAST_NIC, SLOW_NIC, FAST_NIC, SLOW_NIC]
    base = dict(rate_rps=1.2, arrival="poisson",
                policy_mix=(("cachegen", 1.0),),
                max_context=8192, n_devices=n_dev)
    rr = generate_trace(TrafficProfile(**base), n_req, seed=29)
    skewed = generate_trace(
        TrafficProfile(**base, device_mix=((0, 3.0), (1, 1.0),
                                           (2, 3.0), (3, 1.0))),
        n_req, seed=29)
    configs = [
        ("symmetric", "device-nic", rr),
        ("asymmetric", asym, rr),
        ("asymmetric+skewed", asym, skewed),
    ]
    rows = []
    for label, nic, specs in configs:
        rep = ServingCluster(cfg, spcfg, "jetson-orin", "campus-wifi",
                             n_devices=n_dev, nic=nic, n_aps=2,
                             egress="cloud-egress",
                             run_queue=RunQueueModel(2, "fifo"),
                             max_concurrency=n_dev).run(specs)
        s = rep.summary()
        fast = [r.ttft_s for r in rep.records if r.spec.device in (0, 2)]
        slow = [r.ttft_s for r in rep.records if r.spec.device in (1, 3)]
        rows.append({
            "config": label,
            "ttft_mean_s": s["ttft_mean_s"],
            "ttft_p99_s": s["ttft_p99_s"],
            "fast_nic_ttft_s": _mean(fast),
            "slow_nic_ttft_s": _mean(slow),
            "n_fast": len(fast), "n_slow": len(slow),
            "goodput_rps": s["goodput_rps"],
        })
    return rows


def _predictor_refresh_rows(cfg, spcfg, n_req: int) -> list[dict]:
    """SLO admission under bursty compute overload on the starved-egress
    tree: the analytic contention projection vs the online-refreshed
    predictor, epoch style. Both configurations serve identical eval
    specs; the refreshed one first serves a warmup epoch under the
    *analytic* admission with ``predictor.observe`` recording realized
    queue waits and per-stage link shares, then ``refresh()`` fits the
    learned wait/share models and keeps refining online
    (``refresh_every``) through the eval epoch. Bursts are exactly what
    the analytic snapshot terms mispredict: admission at burst onset
    sees an empty queue, while the burst's later arrivals compound every
    in-flight request's waits — a history-trained intercept sees it
    coming."""
    n_dev = 2
    prof = TrafficProfile(rate_rps=1.0, arrival="bursty",
                          burst_factor=7.0, mean_on_s=5.0,
                          mean_off_s=10.0,
                          policy_mix=(("sparkv", 0.5),
                                      ("local_prefill", 0.5)),
                          max_context=8192, n_devices=n_dev,
                          slo_mix=(("interactive", 8.0, 0.7),
                                   ("batch", None, 0.3)))
    eval_specs = generate_trace(prof, n_req, seed=31)
    warm_specs = generate_trace(prof, max(n_req - 6, 6), seed=5)

    def serve(predictor, refresh_every):
        return ServingCluster(cfg, spcfg, "jetson-orin", "campus-wifi",
                              n_devices=n_dev, nic="device-nic", n_aps=2,
                              egress=STARVED_EGRESS,
                              run_queue=RunQueueModel(1, "fifo"),
                              slo=SLOPolicy(), predictor=predictor,
                              refresh_every=refresh_every,
                              max_concurrency=8)

    pred = LatencyPredictor(cfg, PROFILES["jetson-orin"])
    serve(pred, 0).run(warm_specs)            # warmup epoch: observe only
    fit = pred.refresh()
    rows = []
    for label, predictor, refresh_every in (("analytic", None, 0),
                                            ("refreshed", pred, 4)):
        rep = serve(predictor, refresh_every).run(eval_specs)
        s = rep.summary()
        ints = [r.ttft_s for r in rep.records if r.deadline_s is not None]
        rows.append({
            "config": label,
            "slo_attainment": s["slo_attainment"],
            "attainment_arrived": s["slo_attainment_arrived"],
            "n_served": s["n_done"],
            "n_shed": s["n_shed"],
            "n_downgraded": s["n_downgraded"],
            "goodput_slo_rps": s["goodput_slo_rps"],
            "interactive_p99_s": (float(np.percentile(ints, 99))
                                  if ints else None),
            "wait_model_mae_s": (fit or {}).get("wait_mae_s")
            if label == "refreshed" else None,
        })
    return rows


def run(quick: bool = False):
    cfg = get_config("sparkv-qwen3-4b")
    spcfg = SparKVConfig(scheduler_mode="engine")
    n_req = 8 if quick else 18
    out = {}
    out["egress_starvation"] = _egress_starvation_rows(cfg, spcfg, n_req)
    print(table(out["egress_starvation"],
                list(out["egress_starvation"][0].keys()),
                title="\n[topology] telemetry-policy fleet, two-stage vs "
                      "three-hop (starved cloud egress)"))
    out["nic_asymmetry"] = _nic_asymmetry_rows(cfg, spcfg, n_req)
    print(table(out["nic_asymmetry"], list(out["nic_asymmetry"][0].keys()),
                title="\n[topology] symmetric vs asymmetric NIC fleets "
                      "(three-hop tree)"))
    out["predictor_refresh"] = _predictor_refresh_rows(
        cfg, spcfg, 10 if quick else 26)
    print(table(out["predictor_refresh"],
                list(out["predictor_refresh"][0].keys()),
                title="\n[topology] SLO admission on the starved-egress "
                      "tree: analytic vs refreshed predictor"))

    two, _, starved = out["egress_starvation"]
    mix_shifted = (starved["n_local_prefill"] > two["n_local_prefill"])
    ana, ref = out["predictor_refresh"]

    def score(r):
        return (r["slo_attainment"] or 0.0, r["goodput_slo_rps"])

    refresh_wins = score(ref) >= score(ana)
    print(f"\npolicy mix shift (starved egress -> local compute): "
          f"{two['n_local_prefill']} -> {starved['n_local_prefill']} "
          f"local_prefill"
          + ("  [acceptance met]" if mix_shifted else ""))
    att = {r["config"]: r["slo_attainment"] for r in
           out["predictor_refresh"]}
    print(f"refresh attainment: analytic {att['analytic']} -> "
          f"refreshed {att['refreshed']}"
          + ("  [acceptance met]" if refresh_wins else ""))
    save("topology_tree", {**out,
                           "acceptance": {"mix_shifted": mix_shifted,
                                          "refresh_wins": refresh_wins}},
         quick=quick)
    return out


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    a = ap.parse_args()
    run(quick=a.quick)
