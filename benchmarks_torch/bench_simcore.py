"""Simulator-throughput benchmark: the vectorized event core vs the
scalar reference, events/s vs fleet size.

Four studies:

  - **single-uplink head-to-head** — N flows fair-sharing one OU-traced
    uplink (the fleet benches' dominant topology), drained to empty on
    both cores from identical state. Finish times must agree *bitwise*
    (the two cores share ``_delivered_on``/``_finish_on`` and the same
    completion-cache discipline); the acceptance claim is the events/s
    ratio at N=5000.
  - **tree head-to-head** — a NIC -> AP-uplink -> cloud-egress tree
    (multi-stage paths, several path groups) at small N, where the
    scalar core's O(N) per-event completion re-search is still
    tractable. Parity gate: max |Δt| / t ≤ 1e-9 over all completions.
  - **vectorized scaling** — vectorized core only, N up to 100k
    concurrent flows on one shared uplink, telemetry on and off. The
    tentpole target is that a 100k-flow drain *completes*; the
    telemetry=False rows show what fleets that never read
    ``stage_shares`` save.
  - **fleet end-to-end** — identical ``ServingCluster.run`` traffic
    under ``link_core="vectorized"`` vs ``"scalar"``, comparing the
    cluster's own ``last_sim_stats`` (events/s of the whole event loop,
    not just the link server) and asserting the run reports match.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.configs import SparKVConfig, get_config
from repro_torch.core.costs import (NETWORKS, MemoryModel, RunQueueModel,
                              SharedLinkModel)
from repro_torch.core.engine import BandwidthIntegrator
from repro_torch.serving.cluster import ServingCluster
from repro_torch.serving.resources import (LinkTopology, ScalarLinkTopology,
                                     single_link, tree_topology)
from repro_torch.serving.traffic import poisson_trace

from benchmarks_torch.common import save, table

NET = NETWORKS["campus-wifi"]


def _integrator(seed: int, duration_s: float = 60.0,
                profile=NET) -> BandwidthIntegrator:
    rng = np.random.default_rng(seed)
    return BandwidthIntegrator(profile.trace(rng, duration_s), dt=0.01)


def _flow_sizes(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 1)
    return rng.uniform(0.5e6, 8e6, size=n)


def _drain(topo) -> tuple[list, float]:
    """Drain a pre-loaded topology to empty; returns (finish trace as
    [(t, key)] in completion order, wall seconds). One event = one
    next_completion + advance + complete round."""
    finishes = []
    t0 = time.perf_counter()
    while topo.n_active():
        t, key = topo.next_completion()
        topo.advance(t)
        topo.complete(key)
        finishes.append((t, key))
    return finishes, time.perf_counter() - t0


def _load_uplink(cls, n: int, seed: int, *, telemetry: bool = True):
    topo = single_link(_integrator(seed),
                       SharedLinkModel(NET), cls=cls, telemetry=telemetry)
    for i, b in enumerate(_flow_sizes(n, seed)):
        topo.add(i, float(b))
    return topo


def _single_uplink_rows(n_grid: list[int], seed: int = 7) -> list[dict]:
    rows = []
    for n in n_grid:
        fin_s, wall_s = _drain(_load_uplink(ScalarLinkTopology, n, seed))
        fin_v, wall_v = _drain(_load_uplink(LinkTopology, n, seed))
        assert fin_s == fin_v, \
            f"scalar/vectorized drains diverged at N={n}"
        rows.append({
            "n_flows": n,
            "scalar_ev_per_s": n / wall_s,
            "vec_ev_per_s": n / wall_v,
            "speedup": wall_s / wall_v,
            "scalar_wall_s": wall_s,
            "vec_wall_s": wall_v,
            "bitwise_equal": True,
        })
    return rows


def _load_tree(cls, n: int, seed: int):
    n_dev, n_aps = 8, 2
    nics = [_integrator(seed + 10 + d) for d in range(n_dev)]
    ups = [_integrator(seed + 30 + a) for a in range(n_aps)]
    egress = _integrator(seed + 50)
    topo = tree_topology(nics, ups, [d % n_aps for d in range(n_dev)],
                         egress, uplink_link=SharedLinkModel(NET), cls=cls)
    sizes = _flow_sizes(n, seed)
    for i, b in enumerate(sizes):
        d = i % n_dev
        path = (f"nic{d}", f"uplink{d % n_aps}", "egress")
        topo.add(i, float(b), path)
    return topo


def _tree_rows(n: int, seed: int = 11) -> list[dict]:
    fin_s, wall_s = _drain(_load_tree(ScalarLinkTopology, n, seed))
    fin_v, wall_v = _drain(_load_tree(LinkTopology, n, seed))
    assert [k for _, k in fin_s] == [k for _, k in fin_v], \
        "tree drains completed flows in different orders"
    rel = max(abs(ts - tv) / max(ts, 1e-12)
              for (ts, _), (tv, _) in zip(fin_s, fin_v))
    assert rel <= 1e-9, f"tree finish times diverged: rel={rel:.3e}"
    return [{
        "n_flows": n,
        "scalar_ev_per_s": n / wall_s,
        "vec_ev_per_s": n / wall_v,
        "speedup": wall_s / wall_v,
        "max_rel_dt": rel,
    }]


def _scaling_rows(n_grid: list[int], seed: int = 13) -> list[dict]:
    rows = []
    for n in n_grid:
        for telemetry in (True, False):
            if telemetry and n > 20_000:
                continue                     # headline 100k row: lean core
            fin, wall = _drain(_load_uplink(LinkTopology, n, seed,
                                            telemetry=telemetry))
            assert len(fin) == n
            rows.append({
                "n_flows": n,
                "telemetry": telemetry,
                "vec_ev_per_s": n / wall,
                "vec_wall_s": wall,
                "completed": len(fin) == n,
            })
    return rows


def _fleet_rows(n_req: int, seed: int = 17, *,
                rate_rps: float = 2.5,
                max_concurrency: int = 8) -> list[dict]:
    cfg = get_config("sparkv-qwen3-4b")
    spcfg = SparKVConfig(scheduler_mode="engine")
    specs = poisson_trace(n_req, rate_rps, max_context=4096, seed=seed)
    rows, summaries = [], []
    for core in ("vectorized", "scalar"):
        cluster = ServingCluster(cfg, spcfg, "jetson-orin", "campus-wifi",
                                 n_devices=4,
                                 run_queue=RunQueueModel(2, "fifo"),
                                 memory=MemoryModel(capacity_bytes=2e8),
                                 max_concurrency=max_concurrency,
                                 link_core=core)
        report = cluster.run(specs)
        s = report.summary()
        summaries.append((s["ttft_mean_s"], s["goodput_rps"]))
        st = cluster.last_sim_stats
        rows.append({
            "link_core": core,
            "n_events": st["n_events"],
            "events_per_s": st["events_per_s"],
            "wall_s": st["wall_s"],
            "ttft_mean_s": s["ttft_mean_s"],
            "goodput_rps": s["goodput_rps"],
        })
    assert summaries[0] == summaries[1], \
        "vectorized and scalar fleet runs diverged"
    return rows


def run(quick: bool = False):
    out = {}
    h2h_grid = [200, 500] if quick else [500, 2000, 5000]
    out["single_uplink"] = _single_uplink_rows(h2h_grid)
    print(table(out["single_uplink"], list(out["single_uplink"][0].keys()),
                title="\n[simcore] single shared uplink drain: scalar vs "
                      "vectorized (bitwise-locked)"))

    out["tree"] = _tree_rows(48 if quick else 128)
    print(table(out["tree"], list(out["tree"][0].keys()),
                title="\n[simcore] three-hop tree drain: scalar vs "
                      "vectorized (rtol 1e-9)"))

    scale_grid = [500, 2000] if quick else [5000, 20000, 100000]
    out["scaling"] = _scaling_rows(scale_grid)
    print(table(out["scaling"], list(out["scaling"][0].keys()),
                title="\n[simcore] vectorized-core scaling, single uplink"))

    out["fleet"] = _fleet_rows(24, max_concurrency=8) if quick else \
        _fleet_rows(400, rate_rps=8.0, max_concurrency=96)
    print(table(out["fleet"], list(out["fleet"][0].keys()),
                title="\n[simcore] fleet end-to-end event loop: "
                      "link_core vectorized vs scalar"))

    top = out["single_uplink"][-1]
    big = out["scaling"][-1]
    meets_10x = top["speedup"] >= 10.0
    done_100k = any(r["n_flows"] >= 100_000 and r["completed"]
                    for r in out["scaling"]) if not quick else None
    print(f"\nspeedup at N={top['n_flows']}: {top['speedup']:.1f}x"
          + ("  [acceptance met]" if meets_10x else ""))
    print(f"largest drain: N={big['n_flows']} in {big['vec_wall_s']:.1f}s "
          f"({big['vec_ev_per_s']:.0f} ev/s)")
    save("simcore", {**out,
                     "acceptance": {"speedup_at_max_n": top["speedup"],
                                    "max_n_head_to_head": top["n_flows"],
                                    "meets_10x": meets_10x,
                                    "completed_100k": done_100k}},
         quick=quick)
    return out


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    a = ap.parse_args()
    run(quick=a.quick)
