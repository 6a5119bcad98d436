"""The command as the check runs it: refusals without a card or without
the program, what it imports, and (on a card) one short run."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FIRST = BENCH["workloads"][0]["name"]


def _cmd(cwd, *extra, env=None):
    return subprocess.run(
        BENCH["command"] + ["--workload", FIRST, "--seed", "2147483700",
                            "--seconds", "2", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def _no_result(out: str) -> bool:
    for line in out.strip().splitlines()[-1:]:
        try:
            return "correct" not in json.loads(line)
        except ValueError:
            return True
    return True


def test_without_a_card_it_refuses():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _cmd(ROOT, env=env)
    assert p.returncode != 0
    assert _no_result(p.stdout)
    assert "CUDA card" in p.stderr


def test_with_only_the_benchmark_files_it_refuses(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for d in BENCH["paths"]:
        shutil.copytree(ROOT / d, tmp_path / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _cmd(tmp_path, env=env)
    assert p.returncode != 0
    assert _no_result(p.stdout)


GUARD = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
import importlib.util, pathlib
{imports}
for p in sorted(pathlib.Path({metrics!r}).glob("*.py")):
    s = importlib.util.spec_from_file_location("m_" + p.stem, p)
    s.loader.exec_module(importlib.util.module_from_spec(s))
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(imports: str) -> set:
    code = GUARD.format(src=str(ROOT / "src"), root=str(ROOT),
                        imports=imports,
                        metrics=str(ROOT / "cardbench" / "metrics"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    return set(p.stdout.split())


def test_harness_loads_no_jax_nor_the_jax_package():
    mods = _top_level("import cardbench.run, cardbench.harness, "
                      "cardbench.check, cardbench.calibrate\n"
                      "import repro_torch.serving.engine")
    assert "cardbench" in mods and "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_program():
    mods = _top_level("\n".join(
        f"import cardbench.reference.{p.stem}" for p in sorted(
            (ROOT / "cardbench" / "reference").glob("*.py"))
        if p.stem != "__init__"))
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


@pytest.mark.gpu
def test_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = _cmd(ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["attempted"] >= 1
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "check"
