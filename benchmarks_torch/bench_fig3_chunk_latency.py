"""Fig. 3: chunk-level sparse-attention latency heterogeneity — the
ground-truth latency spread across (t, l, h) chunks (paper: 0.13-2.3 ms,
a ~17.7x range)."""
from __future__ import annotations

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.costs import PROFILES, GroundTruthLatency
from repro_torch.data.workloads import DATASETS, synthesize

from benchmarks_torch.common import save, table


def run(quick: bool = False):
    cfg = get_config("sparkv-qwen3-4b")
    gt = GroundTruthLatency(PROFILES["jetson-orin"], cfg.resolved_head_dim)
    rng = np.random.default_rng(0)
    rows = []
    for sample in range(2 if quick else 3):
        wl = synthesize(cfg, 11_264, DATASETS["triviaqa"],
                        rng=np.random.default_rng(sample))
        lat = np.array([
            gt.attn_seconds(wl.active_blocks[t, l, h], 0.0, rng)
            for t in range(wl.n_t) for l in range(wl.n_l)
            for h in range(wl.n_h)]) * 1e3
        rows.append({
            "sample": sample,
            "min_ms": float(lat.min()), "p50_ms": float(np.median(lat)),
            "max_ms": float(lat.max()),
            "spread_x": float(lat.max() / lat.min()),
        })
    print(table(rows, list(rows[0].keys()),
                title="\n[Fig 3] chunk compute-latency heterogeneity "
                      "(TriviaQA-like)"))
    save("fig3_chunk_latency", {"rows": rows}, quick=quick)
    return rows


if __name__ == "__main__":
    run()
