"""The port's benchmark harness against the reference's, bench by bench, on
the CPU under one shared planner (tools/bench_parity.py): the fleet
benches (ROADMAP §1 group c): fleet, slo and decode.

Each case runs the reference's bench and the port's at their own
``--quick`` sizes and holds the saved JSONs equal field for field, but for
the save stamps and the wall-clock fields (``bench_parity.WALL``); the
benches that run a model agree within ``bench_parity.TOLERANCES`` (fig4:
entropies within 0.01 bits, sizes within 0.5%; quality: KL within 1e-6,
top-1 agreement equal). Both packages plan through the port's CPU
predictor, so a last-ulp difference between XLA and torch cannot flip a
greedy choice.
"""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import bench_parity  # noqa: E402


@pytest.mark.parametrize("name", ["fleet", "slo", "decode"])
def test_bench_matches_reference(name):
    res = bench_parity.compare(name)
    assert res["status"] == "match", res
