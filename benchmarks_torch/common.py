"""Shared benchmark utilities of the PyTorch port's harness: result
recording + table printing (port of ``benchmarks/common.py``).

Results go to ``results/benchmarks_torch/``, beside the reference's
``results/benchmarks/``. Quick runs (``--quick``) are smoke tests on
reduced workloads: their numbers are not comparable to full runs, so
:func:`save` routes them to ``results/benchmarks_torch/quick/``
(git-ignored) — a quick run can never clobber a checked-in full-run
result. Every bench must pass its ``quick`` flag through to ``save``
(enforced by tests/test_torch_benchmarks.py). Every saved JSON names the
device the bench ran on (``_device``): the card's name, or ``cpu``.
"""
from __future__ import annotations

import json
import os
import time

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "results",
                           "benchmarks_torch")
QUICK_DIR = os.path.join(RESULTS_DIR, "quick")

# --profile (benchmarks_torch/run.py): stamp a ``_profile`` block into
# every saved JSON with the bench's wall-clock and the
# simulator-throughput counters accumulated by ServingCluster.run since
# begin_bench().
PROFILE = False
_bench_t0: float | None = None


def begin_bench() -> None:
    """Mark the start of one bench module's run: reset the wall clock
    and the process-wide simulator event counters so the next
    :func:`save` snapshots only this bench's activity."""
    global _bench_t0
    _bench_t0 = time.time()
    from repro_torch.serving.simcore import STATS
    STATS.reset()


def _profile_snapshot() -> dict:
    from repro_torch.serving.simcore import STATS
    prof: dict = {}
    if _bench_t0 is not None:
        prof["bench_wall_s"] = time.time() - _bench_t0
    prof.update(STATS.snapshot())
    return prof


def device_name() -> str:
    """The device the harness runs on (``repro_torch.device.resolve``):
    the card's name, or the device type."""
    import torch

    from repro_torch.device import resolve
    dev = resolve()
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)


def save(name: str, payload: dict, *, quick: bool = False):
    out_dir = QUICK_DIR if quick else RESULTS_DIR
    os.makedirs(out_dir, exist_ok=True)
    payload = dict(payload, _bench=name, _time=time.time(), _quick=quick,
                   _device=device_name())
    if PROFILE:
        payload["_profile"] = _profile_snapshot()
    path = os.path.join(out_dir, f"{name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=str)
    return path


def table(rows: list[dict], cols: list[str], *, title: str = "",
          fmt: dict | None = None) -> str:
    fmt = fmt or {}
    widths = {c: max([len(c)] + [len(_cell(r.get(c), fmt.get(c)))
                                 for r in rows]) for c in cols}
    out = []
    if title:
        out.append(title)
    out.append("  ".join(c.ljust(widths[c]) for c in cols))
    out.append("  ".join("-" * widths[c] for c in cols))
    for r in rows:
        out.append("  ".join(
            _cell(r.get(c), fmt.get(c)).ljust(widths[c]) for c in cols))
    return "\n".join(out)


def _cell(v, f) -> str:
    if v is None:
        return "-"
    if f:
        return format(v, f)
    if isinstance(v, float):
        return f"{v:.3f}"
    return str(v)
