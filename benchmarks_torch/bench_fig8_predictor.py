"""Fig. 8: MLP latency predictor vs analytical roofline baseline —
prediction error and per-chunk inference overhead (paper: 4.8-5.6x error
reduction at comparable overhead)."""
from __future__ import annotations

import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.costs import PROFILES
from repro_torch.core.predictor import LatencyPredictor

from benchmarks_torch.common import save, table


def run(quick: bool = False):
    rows = []
    for profile in (["jetson-orin"] if quick
                    else ["jetson-orin", "jetson-agx"]):
        cfg = get_config("sparkv-qwen3-4b")
        pred = LatencyPredictor(cfg, PROFILES[profile])
        t0 = time.time()
        rep = pred.fit(6000, epochs=150 if quick else 400)
        fit_s = time.time() - t0
        # per-chunk inference overhead
        x = np.array([[3, 200, 0.2]], np.float32)
        t0 = time.time()
        for _ in range(100):
            pred.predict_ms(x)
        infer_ms = (time.time() - t0) / 100 * 1e3
        rows.append({
            "profile": profile,
            "train_s": fit_s,
            "infer_overhead_ms": infer_ms,
            "mlp_mae_ms": rep["test"]["mlp_mae_ms"],
            "roofline_mae_ms": rep["test"]["roofline_mae_ms"],
            "mlp_mape": rep["test"]["mlp_mape"],
            "roofline_mape": rep["test"]["roofline_mape"],
            "error_reduction_x": rep["test"]["improvement"],
        })
    print(table(rows, list(rows[0].keys()),
                title="\n[Fig 8] latency predictor vs roofline baseline"))
    save("fig8_predictor", {"rows": rows}, quick=quick)
    return rows


if __name__ == "__main__":
    run()
