"""The port's copies of numpy-only modules cannot drift from the JAX
package: each equals its reference once `repro_torch` is read as `repro`
(the only edit a copy may carry is the retargeted package name)."""
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1] / "src"
COPIES = sorted(
    [str(p.relative_to(ROOT / "repro"))
     for p in (ROOT / "repro" / "configs").glob("*.py")]
    + ["compression/__init__.py", "compression/quantize.py",
       "compression/huffman.py", "compression/allocate.py",
       "data/__init__.py", "data/workloads.py", "core/chunks.py",
       "core/costs.py", "core/scheduler.py", "core/controller.py",
       "core/engine.py", "core/baselines.py", "core/lp.py",
       "core/milp.py", "serving/simcore.py", "serving/resources.py",
       "serving/kvstore.py", "serving/decode.py", "serving/memory.py",
       "serving/scenarios.py", "serving/slo.py", "serving/cluster.py",
       "serving/traffic.py", "distributed/analytic.py"])


def test_copy_list_covers_every_config():
    assert len([c for c in COPIES if c.startswith("configs/")]) == 13


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_reference(rel):
    ref = (ROOT / "repro" / rel).read_text()
    copy = (ROOT / "repro_torch" / rel).read_text()
    assert copy.replace("repro_torch", "repro") == ref
    # and every import of the reference's own package is retargeted
    assert "from repro." not in copy
