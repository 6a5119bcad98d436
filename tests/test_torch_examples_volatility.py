"""serve_under_volatility, copied into the port's examples, prints the
reference's lines, line for line, on the CPU under one shared planner
(``tools/bench_parity.py::shared_planner``). Its own file: each side
simulates 12 loads of a 12,000-token context (about a minute of host
work), so it is the slowest example to hold.
"""
import contextlib
import io
import runpy
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import bench_parity  # noqa: E402

import examples_torch.run as RUN  # noqa: E402


def stdout_of(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return buf.getvalue(), out


def test_serve_under_volatility_prints_the_reference_lines():
    with bench_parity.shared_planner():
        ref, _ = stdout_of(lambda: runpy.run_path(
            str(ROOT / "examples" / "serve_under_volatility.py"),
            run_name="__main__"))
        port, _ = stdout_of(lambda: RUN.main(
            ["serve_under_volatility", "--device", "cpu"]))
    # the workload line, the header and one row a network
    assert len(ref.splitlines()) == 5
    assert port.splitlines() == ref.splitlines()
