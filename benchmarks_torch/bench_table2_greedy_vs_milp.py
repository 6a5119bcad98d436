"""Table II: potential-aware greedy vs exact MILP (branch & bound over the
in-repo simplex) — scheduling runtime and resulting TTFT.

Exact MILP solving scales poorly (the paper's point), so the exact column
runs on reduced grids; greedy runs on both the reduced and full grids.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.configs import SparKVConfig, get_config
from repro_torch.core import baselines as B
from repro_torch.core.chunks import ChunkGrid
from repro_torch.core.costs import NETWORKS, PROFILES, t_stream
from repro_torch.core.milp import MILPProblem, solve_bnb
from repro_torch.core.scheduler import GreedyScheduler
from repro_torch.data.workloads import DATASETS, synthesize

from benchmarks_torch.common import save, table


def _small_instance(cfg, wl, net, spcfg, n_t, n_l):
    """Aggregate a workload down to an (n_t, n_l) grid for the oracle."""
    grid = ChunkGrid(n_t, n_l, 1)
    tt = np.linspace(0, wl.n_t, n_t + 1, dtype=int)
    ll = np.linspace(0, wl.n_l, n_l + 1, dtype=int)
    prof = PROFILES["jetson-orin"]
    ts = np.zeros(grid.size)
    tc = np.zeros(grid.size)
    from repro_torch.core.baselines import _predictor_cache
    pred = _predictor_cache(cfg, "jetson-orin")
    for i, c in enumerate(grid.chunks()):
        byts = wl.chunk_bytes[tt[c.t]:tt[c.t + 1],
                              ll[c.l]:ll[c.l + 1]].sum()
        act = wl.active_blocks[tt[c.t]:tt[c.t + 1],
                               ll[c.l]:ll[c.l + 1]].sum()
        ts[i] = t_stream(byts, net.mean_bw, prof)
        tc[i] = float(pred.t_comp_batch(
            np.array([float(c.t)]), np.array([c.l if c.l < n_l - 1 else 0]),
            np.array([act]), 0.0)[0])
    return grid, ts, tc


def run(quick: bool = False):
    cfg = get_config("sparkv-qwen3-4b")
    spcfg = SparKVConfig()
    net = NETWORKS["campus-wifi"]
    rows = []
    cases = [("longchat", 10_240), ("videomme", 10_240)]
    if not quick:
        cases += [("longchat", 20_480), ("videomme", 20_480)]
    for ds, ctx in cases:
        wl = synthesize(cfg, ctx, DATASETS[ds])
        # --- exact oracle on the reduced grid ---
        grid, ts, tc = _small_instance(cfg, wl, net, spcfg,
                                       n_t=3, n_l=3)
        prob = MILPProblem(grid, ts, tc, n_stages=3)
        t0 = time.time()
        greedy = GreedyScheduler(grid, ts, tc,
                                 stage_budget_s=max(ts.sum(), tc.sum())
                                 / 3).run()
        t_greedy = time.time() - t0
        t0 = time.time()
        exact = solve_bnb(prob, incumbent=greedy.makespan * 1.001,
                          max_nodes=1500)
        t_exact = time.time() - t0
        # --- greedy TTFT on the full engine ---
        res = B.run_sparkv(cfg, wl, "jetson-orin", net, spcfg, seed=0,
                           adapt=False)
        rows.append({
            "dataset": ds, "ctx": ctx,
            "greedy_runtime_s": t_greedy,
            "exact_runtime_s": t_exact,
            "speedup": t_exact / max(t_greedy, 1e-9),
            "greedy_makespan_s": greedy.makespan,
            "exact_makespan_s": exact.objective,
            "gap": (greedy.makespan - exact.objective)
            / max(exact.objective, 1e-9),
            "engine_ttft_s": res.ttft_s,
            "bnb_nodes": exact.nodes,
        })
    print(table(rows, list(rows[0].keys()),
                title="\n[Table II] greedy heuristic vs exact MILP "
                      "(reduced oracle grids)"))
    save("table2_greedy_vs_milp", {"rows": rows}, quick=quick)
    return rows


if __name__ == "__main__":
    run()
