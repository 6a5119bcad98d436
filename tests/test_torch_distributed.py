"""The port's sharding stack on several ranks: gloo process groups of 2, 4
and 8 CPU processes, each case a subprocess of its own ranks
(tests/torch_dist_worker.py, which blocks JAX and the JAX package) with a
300 s limit. Smoke configs, fp32, numpy-drawn weights.

  - jit_train_step against build_train_step on one rank, 2 steps, for
    every family on a (2, 4) ("data", "model") mesh and a (2, 2, 2)
    ("pod", "data", "model") mesh, and once with heads that do not divide
    the model axis (sequence-parallel attention). Bounds: loss within
    1e-5; params and both moments within 1e-5 of each leaf's largest
    magnitude, under the reference's default schedule (Adam's first
    steps move an element by about lr * sign(g), so with a large lr fp32
    noise in grads near zero shows in the params). The MoE family is
    held to its own semantics on one rank: tokens routed as
    moe_block_local routes them,
    the router loss of each data shard averaged over the shards, as the
    reference's shard_map dispatch computes it; its capacity factor is
    8.0, tests/test_sharding.py's, so that no assignment is dropped
    (capacity is per local route on the mesh).
  - Each rank's block of every param against the block that the
    reference's NamedSharding(mesh, spec).devices_indices_map gives the
    device at the same mesh coordinates (a JAX subprocess with 8 host
    devices), including the weight-stationary MoE layout whose d_ff split
    is ("model", "data"), not in the mesh's order.
  - moe_block_sharded against moe_block_local on (2, 4), 8 experts (EP)
    and 6 (TP), FSDP and weight-stationary layouts: y within 1e-4 (the
    bound of tests/test_sharding.py), gradients within 1e-5 of each
    leaf's largest; y and aux against the reference's moe_block_sharded
    on the same inputs (8 host devices): y within 1e-4, aux within 1e-6.
  - compressed_psum at 2 and 4 ranks: the mean within half a quantization
    step of the exact mean, the residual carried exactly, and over two
    steps the sum sent equal to the mean of the grads less the final
    residuals (to fp32 rounding).
  - Elastic restore: save from a (1, 4) run, restore onto (4, 1) and
    (2, 2) with `shardings=`; 2 more steps give the params of 2 more steps
    on (1, 4) within 1e-5; the checkpoint equals, file for file, what the
    reference's CheckpointManager writes for the state it restores.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import CheckpointManager as JCM  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.training.optimizer import AdamWState as JState  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_dist_worker.py"
TIMEOUT = 300


def run_ranks(case, args, world, tmp_path):
    """Start `world` ranks of the worker on one FileStore; the result
    rank 0 wrote. Fails with the first failing rank's output."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               WORLD_SIZE=str(world), STORE=str(tmp_path / "store"))
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), case, json.dumps(args), str(tmp_path)],
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
    assert not bad, (rcs, (tmp_path / f"rank{bad[0]}.log").read_text()[-4000:])
    return json.loads((tmp_path / "result.json").read_text())


def run_jax(script, *args):
    """A JAX subprocess with 8 host devices; its last stdout line, JSON."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", script, *args], env=env,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# ------------------------------------------------------- the sharded step

MESHES = {"2x4": ([2, 4], ["data", "model"]),
          "2x2x2": ([2, 2, 2], ["pod", "data", "model"])}
FAMILIES = {"dense": ("qwen2.5-3b", {}),
            "moe": ("granite-moe-3b-a800m", {"moe": {"capacity_factor": 8.0}}),
            "ssm": ("mamba2-130m", {}),
            "hybrid": ("zamba2-2.7b", {}),
            "encdec": ("whisper-tiny", {})}


def _check_step(res):
    assert res["dtensors"] and res["count"] == 2
    for a, b in res["loss"]:
        assert abs(a - b) < 1e-5, res["loss"]
    for a, b in res["grad_norm"]:
        assert abs(a - b) <= 1e-5 * abs(b), res["grad_norm"]
    for k in ("params", "m", "v"):
        assert res["errs"][k] < 1e-5, res["errs"]
    # the mesh really split something
    assert any("Shard" in p for p in res["placements"].values())


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sharded_step_matches_unsharded(family, mesh, tmp_path):
    arch, overrides = FAMILIES[family]
    shape, axes = MESHES[mesh]
    res = run_ranks("step", {"arch": arch, "mesh_shape": shape, "axes": axes,
                             "overrides": dict(overrides)}, 8, tmp_path)
    _check_step(res)
    assert res["table"]["batch"] == [a for a in axes if a != "model"]


def test_sequence_parallel_step(tmp_path):
    """6 heads over a model axis of 4: heads fall back, the seq dims take
    the model axis, attention runs on sequence blocks."""
    res = run_ranks("step", {
        "arch": "qwen2.5-3b", "mesh_shape": [2, 4], "axes": ["data", "model"],
        "overrides": {"num_heads": 6, "num_kv_heads": 2, "head_dim": 16}},
        8, tmp_path)
    _check_step(res)
    assert res["table"]["heads"] == [] and res["table"]["seq"] == ["model"]
    assert res["table"]["block_seq"] == ["model"]


# ----------------------------------------------------------- local shards

LAYOUTS = [[[2, 4], ["data", "model"], "qwen2.5-3b", {}, False],
           [[2, 2, 2], ["pod", "data", "model"], "qwen2.5-3b", {}, False],
           [[2, 4], ["data", "model"], "granite-moe-3b-a800m",
            {"num_experts": 6}, True],
           [[2, 2, 2], ["pod", "data", "model"], "granite-moe-3b-a800m",
            {"num_experts": 6}, True],
           [[2, 2, 2], ["pod", "data", "model"], "zamba2-2.7b", {}, False]]

INDICES_SCRIPT = r"""
import dataclasses, json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_smoke
from repro.distributed.sharding import make_rules
from repro.models import build_model

def paths(t, pre=""):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from paths(t[k], pre + "/" + k)
    else:
        yield pre, t

out = {}
for mesh_shape, axes, arch, overrides, ws in json.loads(sys.argv[1]):
    cfg = get_smoke(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **overrides))
    devs = np.array(jax.devices()[:8]).reshape(mesh_shape)
    mesh = Mesh(devs, tuple(axes))
    rules = make_rules(cfg, mesh, weight_stationary=ws)
    res = {}
    for path, d in paths(build_model(cfg).param_defs()):
        m = NamedSharding(mesh, rules.spec(d.axes, d.shape)
                          ).devices_indices_map(d.shape)
        res[path] = [[list(range(*sl.indices(n))) for sl, n in
                      zip(m[dev], d.shape)] for dev in devs.flat]
    key = arch + "|" + "x".join(map(str, mesh_shape)) + "|" + str(ws)
    out[key] = res
print(json.dumps(out))
"""


def test_local_shards_match_reference_device_indices(tmp_path):
    """Rank r at mesh coordinates c holds exactly the block JAX gives the
    device at c, for every param, split order included."""
    mine = run_ranks("shards", {"layouts": LAYOUTS}, 8, tmp_path)
    ref = run_jax(INDICES_SCRIPT, json.dumps(LAYOUTS))
    assert sorted(mine) == sorted(ref)
    for key in ref:
        assert sorted(mine[key]) == sorted(ref[key]), key
        for path in ref[key]:
            assert mine[key][path] == ref[key][path], (key, path)
    # d_ff split over ("model", "data") on a ("data", "model") mesh is
    # model-major: rank 1 (data 0, model 1) holds the third eighth, where
    # the mesh's own order would give it the second
    f = jget_smoke("granite-moe-3b-a800m").d_ff
    w_up = mine["granite-moe-3b-a800m|2x4|True"]["/blocks/moe/w_up"]
    assert w_up[1][3][0] == 2 * f // 8 and w_up[2][3][0] == 4 * f // 8


# ------------------------------------------------------------- sharded MoE

MOE_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs.base import ModelConfig, MoEConfig
from repro.distributed.sharding import make_rules, use_rules
from repro.models import layers as L

out = {}
for n_exp, ws in json.loads(sys.argv[1]):
    cfg = ModelConfig(name="t", family="moe", num_layers=2, d_model=32,
                      num_heads=4, num_kv_heads=2, d_ff=16, vocab_size=128,
                      moe=MoEConfig(num_experts=n_exp, experts_per_token=2,
                                    capacity_factor=8.0))
    rng = np.random.default_rng(0)
    defs = L.moe_defs(cfg)
    p = {k: jnp.asarray((rng.normal(size=defs[k].shape) * defs[k].scale
                         ).astype(np.float32)) for k in sorted(defs)}
    x = jnp.asarray(rng.normal(size=(4, 8, 32)).astype(np.float32))
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    rules = make_rules(cfg, mesh, weight_stationary=ws)
    def f(p, x):
        with use_rules(rules):
            return L.moe_block_sharded(cfg, p, x, rules)
    y, aux = jax.jit(f)(p, x)
    out[f"{n_exp}|{ws}"] = {"y": np.asarray(y).tolist(), "aux": float(aux)}
print(json.dumps(out))
"""

MOE_CASES = [(8, False), (6, False), (8, True), (6, True)]


@pytest.fixture(scope="module")
def reference_moe():
    return run_jax(MOE_SCRIPT, json.dumps(MOE_CASES))


@pytest.mark.parametrize("n_exp,ws", MOE_CASES,
                         ids=["ep", "tp", "ep-weight-stationary",
                              "tp-weight-stationary"])
def test_moe_block_sharded(n_exp, ws, reference_moe, tmp_path):
    res = run_ranks("moe", {"n_exp": n_exp, "weight_stationary": ws}, 8,
                    tmp_path)
    assert res["is_dtensor"]
    assert res["y_placements"] == "(Shard(dim=0), Replicate())"
    assert res["y_err"] < 1e-4
    assert abs(res["aux"] - res["aux_oracle"]) <= 1e-6 * res["aux_oracle"]
    assert max(res["grad_errs"]) < 1e-5, res["grad_errs"]
    # the layout the mode asks for: experts on model (EP) or d_ff (TP)
    up = res["placements"]["w_up"]
    assert ("Shard(dim=0)" in up) == (n_exp % 4 == 0), up
    if ws and n_exp % 4:
        assert "_StridedShard(dim=2, sf=4)" in up
    ref = reference_moe[f"{n_exp}|{ws}"]
    with np.load(tmp_path / "moe.npz") as z:
        assert float(np.abs(z["y"] - np.asarray(ref["y"])).max()) < 1e-4
        assert abs(float(z["aux"]) - ref["aux"]) <= 1e-6 * abs(ref["aux"])


# ------------------------------------------------------ int8 all-reduce


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_over_ranks(world, tmp_path):
    res = run_ranks("psum", {}, world, tmp_path)
    assert res["world"] == world
    assert res["worst_in_steps"] <= 0.5 + 1e-4     # in grid steps
    assert res["residual_err"] == 0.0
    assert res["ef_err"] < 1e-7
    assert res["residual_nonzero"] > 0


# ------------------------------------------------------- elastic restore


def test_elastic_restore_across_meshes(tmp_path):
    res = run_ranks("elastic", {}, 4, tmp_path)
    assert sorted(res["meshes"]) == ["(2, 2)", "(4, 1)"]
    for shape, r in res["meshes"].items():
        assert r["err"] < 1e-5, (shape, r["err"])
    assert any("Shard(dim=1), Shard" in p
               for p in res["meshes"]["(2, 2)"]["placements"])
    # the reference restores the port's checkpoint and writes it again:
    # the same files
    jm = jbuild(jget_smoke("qwen2.5-3b"))
    zeros = jax.tree.map(lambda d: np.zeros(d.shape, np.float32),
                         jm.param_defs(), is_leaf=JL.is_def)
    like = {"params": zeros, "opt": JState(m=zeros, v=zeros,
                                           count=np.zeros((), np.int32))}
    step = res["step"]
    state = JCM(res["ckpt"]).restore(step, like=like)
    JCM(str(tmp_path / "ref"), async_save=False).save(state, step)
    mine = Path(res["ckpt"]) / f"step-{step}"
    theirs = tmp_path / "ref" / f"step-{step}"
    idx_m = json.loads((mine / "index.json").read_text())
    idx_t = json.loads((theirs / "index.json").read_text())
    assert idx_m["leaves"] == idx_t["leaves"]
    assert len(idx_m["leaves"]) == len(jax.tree.leaves(like))
    for e in idx_m["leaves"]:
        name = f"leaf_{e['i']}.npy"
        assert (mine / name).read_bytes() == (theirs / name).read_bytes()
