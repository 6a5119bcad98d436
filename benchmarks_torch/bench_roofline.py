"""§Roofline table: per-(arch x shape) roofline terms of the port's dry
run on the H100 model (port of ``benchmarks/bench_roofline.py``).

Reads the records of ``python -m repro_torch.launch.dryrun`` in
``results/dryrun_torch/<mesh>/`` and prices each OK cell with
``repro_torch/distributed/roofline.py`` (one NVIDIA H100 80GB HBM3 a
rank, 700 W):

    compute_s    = flops_per_dev / 989e12          (dense bf16 peak)
    memory_s     = analytic bytes_per_dev / 3.35e12 (HBM3)
    collective_s = nvlink wire bytes / 450e9 + nic wire bytes / 50e9

plus MODEL_FLOPS = 6·N·D (train) / 2·N·D (prefill) / 2·N·B (decode) and
the useful-compute ratio MODEL_FLOPS / (flops x chips). These are
estimates for that hardware model, not measurements. The port's dry run
counts every local op as it runs (remat included), so its flops and
collectives need no depth calibration (``src`` is "dryrun"). The memory
term is the analytic HBM-traffic model (``distributed/analytic.py``), as
in the reference: the dry run's unfused op bytes are not HBM traffic.
"""
from __future__ import annotations

import glob
import json

from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed.analytic import analytic_bytes
from repro_torch.distributed.roofline import (HBM_BW, NIC_BW, NVLINK_BW,
                                              PEAK_FLOPS, CollectiveStats,
                                              roofline_terms)

from benchmarks_torch.common import save, table

DRYRUN_DIR = "results/dryrun_torch"


def cell_terms(dr: dict) -> dict:
    """The roofline terms of one OK dry-run record."""
    coll = CollectiveStats()
    coll.by_link.update(dr["collectives"]["by_link"])
    byts = analytic_bytes(get_config(dr["arch"]), SHAPES[dr["shape"]],
                          dr["chips"])["bytes_per_dev"]
    return roofline_terms(dr["cost"]["flops_per_dev"], byts, coll)


def load_cells(mesh_tag: str = "pod16x16"):
    rows = []
    for path in sorted(glob.glob(f"{DRYRUN_DIR}/{mesh_tag}/*.json")):
        with open(path) as f:
            dr = json.load(f)
        if dr["status"] == "SKIP":
            rows.append({"arch": dr["arch"], "shape": dr["shape"],
                         "status": "SKIP", "note": dr["reason"][:40]})
            continue
        if dr["status"] != "OK":
            rows.append({"arch": dr["arch"], "shape": dr["shape"],
                         "status": dr["status"]})
            continue
        terms = cell_terms(dr)
        flops, chips = dr["cost"]["flops_per_dev"], dr["chips"]
        rows.append({
            "arch": dr["arch"], "shape": dr["shape"], "status": "OK",
            "mem_GiB": dr["memory"]["peak_est_bytes"] / 2**30,
            "compute_ms": terms["compute_s"] * 1e3,
            "memory_ms": terms["memory_s"] * 1e3,
            "collective_ms": terms["collective_s"] * 1e3,
            "dominant": terms["dominant"],
            "bound_ms": terms["step_lower_bound_s"] * 1e3,
            "roofline_frac": terms["compute_fraction_of_bound"],
            "useful_ratio": (dr["model_flops"] / (flops * chips)
                             if flops else 0.0),
            "src": "dryrun",
        })
    return rows


def run(quick: bool = False, mesh_tag: str = "pod16x16"):
    rows = load_cells(mesh_tag)
    if not rows:
        raise FileNotFoundError(
            f"no dry-run records in {DRYRUN_DIR}/{mesh_tag}: run "
            "python -m repro_torch.launch.dryrun first")
    cols = ["arch", "shape", "status", "mem_GiB", "compute_ms",
            "memory_ms", "collective_ms", "dominant", "roofline_frac",
            "useful_ratio", "src"]
    print(table(rows, cols,
                title=f"\n[Roofline] per-cell terms ({mesh_tag}, H100 "
                      f"model: {PEAK_FLOPS / 1e12:.0f} TF/s, "
                      f"{HBM_BW / 1e12:.2f} TB/s HBM, NVLink "
                      f"{NVLINK_BW / 1e9:.0f} GB/s, NIC {NIC_BW / 1e9:.0f}"
                      " GB/s; estimates)"))
    save(f"roofline_{mesh_tag}", {"rows": rows}, quick=quick)
    return rows


if __name__ == "__main__":
    run()
