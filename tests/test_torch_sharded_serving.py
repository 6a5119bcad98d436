"""Prefill and decode over DTensors on several ranks: gloo process groups
of 2, 4 and 8 CPU processes (tests/torch_dist_worker.py's "serve" case,
which blocks JAX and the JAX package), smoke configs of the five
families, fp32, numpy-drawn weights.

Each mesh runs once (a module fixture) and every family on it: prefill
under the prefill rules, its outputs laid out by prefill_out_axes; the
decode cache built from it and laid out by cache_axes; then 4 decode
steps under the weight-stationary rules (the reference's dry-run
layouts). Logits of the prefill and of every decode step, the prefill's
cache and the final decode cache are held within 1e-5 of each leaf's
largest magnitude against the same run on one rank without a mesh. The
MoE smoke config takes capacity factor 8.0 (tests/test_sharding.py's),
so that no assignment is dropped: capacity is per local route on the
mesh.

The meshes cover head-parallel attention with a kv-head split (2x2), a
seq-sharded decode cache under head-sharded queries (2x4: 4 q heads, 2
kv heads on a model axis of 4), sequence-parallel prefill with a
seq-sharded cache (1x8: 4 heads on 8), the Mamba2 block's channel split
with its conv window and state, and a three-axis mesh (2x2x2).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_dist_worker.py"
TIMEOUT = 300
BOUND = 1e-5

FAMILIES = {"dense": "qwen2.5-3b", "moe": "granite-moe-3b-a800m",
            "ssm": "mamba2-130m", "hybrid": "zamba2-2.7b",
            "encdec": "whisper-tiny"}
MESHES = {"1x2": ([1, 2], ["data", "model"]),
          "2x2": ([2, 2], ["data", "model"]),
          "2x4": ([2, 4], ["data", "model"]),
          "1x8": ([1, 8], ["data", "model"]),
          "2x2x2": ([2, 2, 2], ["pod", "data", "model"])}


def run_ranks(args, world, out, case="serve"):
    """Start `world` ranks of the worker's `case` on one FileStore; the
    result rank 0 wrote. Fails with the first failing rank's output."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               WORLD_SIZE=str(world), STORE=str(out / "store"))
    logs = [open(out / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), case, json.dumps(args), str(out)],
        env=dict(env, RANK=str(r)), stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        rcs = [p.wait(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, rc in enumerate(rcs) if rc]
    assert not bad, (rcs, (out / f"rank{bad[0]}.log").read_text()[-4000:])
    return json.loads((out / "result.json").read_text())


_RESULTS: dict = {}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    def get(mesh):
        if mesh not in _RESULTS:
            shape, axes = MESHES[mesh]
            world = 1
            for s in shape:
                world *= s
            _RESULTS[mesh] = run_ranks(
                {"archs": list(FAMILIES.values()), "mesh_shape": shape,
                 "axes": axes}, world, tmp_path_factory.mktemp(mesh))
        return _RESULTS[mesh]
    return get


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_prefill_and_decode_match_one_rank(served, mesh, family):
    res = served(mesh)[FAMILIES[family]]
    assert res["dtensors"], res
    assert max(res["prefill"].values()) < BOUND, res["prefill"]
    assert len(res["logits"]) == (4 if family == "encdec" else 5)
    assert max(res["logits"]) < BOUND, res["logits"]
    assert max(res["cache"].values()) < BOUND, res["cache"]
    # the cache really is split over the mesh
    assert any("Shard" in p for p in res["cache_placements"].values()), res
