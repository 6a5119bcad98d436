"""The port's dry run (repro_torch/launch/dryrun.py) and calibration
(launch/calibrate.py) on a fake process group of 256 ranks, CPU meshes;
each case in a subprocess of its own (the port's with JAX and the JAX
package blocked).

  - mamba2-130m x decode_32k traces OK on the 16x16 mesh, with every key
    of the record (tests/test_sharding.py's dry-run cell, restated); its
    weight-stationary decode moves no weight: all its all-gathers
    together carry less than the bf16 embedding table. With the cell
    limit at 0 s the same cell stops and its record says so.
  - Rank 0's local shape of every param, optimizer moment and input leaf
    of that cell, of qwen2.5-3b x train_4k and of granite-moe-3b-a800m x
    decode_32k (a d_ff split in the spec's order, not the mesh's: a
    _StridedShard) equals the reference's
    NamedSharding(mesh, spec).shard_shape(shape) on 256 of 512 host
    devices (shape arithmetic only; nothing compiles).
  - flops_per_dev counts rank 0's local work: a DTensor matmul counts its
    local block's product, not the global op's (torch's FlopCounterMode
    around DTensor ops counts the global op), and compute replicated on
    a mesh dim is counted on every rank of it.
  - calibrate_cell's extrapolation from depths (2, 4) to 6 equals a
    direct count at depth 6 on smoke configs (an eager count is exact
    per layer), flops, bytes and wire bytes alike.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 600

BLOCK = r"""
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".")
               for b in ("jax", "jaxlib", "repro")):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
import warnings
warnings.filterwarnings("ignore")
import torch
torch.set_num_threads(1)
"""


def run(code, *args, jax=False):
    """A subprocess (the port's: JAX blocked; or the reference's, with
    512 host devices); its last stdout line, JSON."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    if jax:
        env.update(JAX_PLATFORMS="cpu")
    else:
        code = BLOCK + code
    out = subprocess.run([sys.executable, "-c", code, *args], env=env,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


CELL = r"""
import json, sys
from repro_torch.launch.dryrun import run_cell
import torch.distributed as dist
rec = run_cell("mamba2-130m", "decode_32k", False, sys.argv[1],
               verbose=False, device="cpu")
dist.destroy_process_group()
print(json.dumps(rec))
"""


def test_mamba_decode_cell_on_256_fake_ranks(tmp_path):
    rec = run(CELL, str(tmp_path))
    assert rec["status"] == "OK", rec.get("traceback", rec)
    assert rec["chips"] == 256 and rec["device"] == "cpu"
    for k in ("trace_s", "local_ops", "memory", "cost", "collectives",
              "roofline", "model_flops", "useful_flops_ratio", "params",
              "active_params", "top_ops"):
        assert k in rec, k
    m = rec["memory"]
    assert set(m) == {"argument_bytes", "output_bytes", "temp_bytes",
                      "peak_est_bytes"}
    assert 0 < m["argument_bytes"] <= m["peak_est_bytes"] < 80e9
    assert set(rec["cost"]) == {"flops_per_dev", "bytes_per_dev",
                                "analytic_bytes_per_dev"}
    assert rec["cost"]["flops_per_dev"] > 0
    assert set(rec["collectives"]) == {"wire_bytes", "payload_bytes",
                                       "count", "by_kind", "by_link"}
    # the 16x16 mesh's groups all span nodes of 8: every byte on the NIC
    assert rec["collectives"]["by_link"]["nvlink"] == 0.0
    gathered = rec["collectives"]["by_kind"]["all-gather"]["wire_bytes"]
    assert gathered < 50280 * 768 * 2, rec["collectives"]["by_kind"]
    assert set(rec["roofline"]) == {
        "compute_s", "memory_s", "collective_s", "dominant",
        "step_lower_bound_s", "compute_fraction_of_bound"}
    # the record on disk is the one returned
    path = tmp_path / "pod16x16" / "mamba2-130m__decode_32k.json"
    assert json.loads(path.read_text())["status"] == "OK"


LIMITED = r"""
import json, sys
from repro_torch.launch import dryrun as D
import torch.distributed as dist
D.CELL_LIMIT_S = 0.0
rec = D.run_cell("mamba2-130m", "decode_32k", False, sys.argv[1],
                 verbose=False, device="cpu")
dist.destroy_process_group()
print(json.dumps(rec))
"""


def test_cell_past_its_time_limit_says_so(tmp_path):
    rec = run(LIMITED, str(tmp_path))
    assert rec["status"] == "FAIL" and rec["timed_out"], rec
    assert "cell limit" in rec["error"], rec["error"]


PORT_SHAPES = r"""
import json, sys
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.distributed.sharding import Sharding
from repro_torch.launch import dryrun as D
mesh = D.production_mesh(False, torch.device("cpu"))
out = {}
for cell in sys.argv[1:]:
    arch, shape = cell.split(":")
    fn, args, in_sh, _, _ = D.build_cell(arch, shape, mesh)
    with FakeTensorMode():
        shapes = D._zip_map(
            lambda sh, meta: list(D.fake_dtensor(meta, sh, "cpu")
                                  .to_local().shape),
            tuple(in_sh), tuple(args), lambda x: isinstance(x, Sharding))
    def walk(t, pre):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], f"{pre}/{k}")
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for k, v in zip(t._fields, t):
                walk(v, f"{pre}/{k}")
        elif isinstance(t, tuple):
            for i, v in enumerate(t):
                walk(v, f"{pre}/{i}")
        else:
            out[f"{cell}{pre}"] = t
    walk(shapes, "")
dist.destroy_process_group()
print(json.dumps(out))
"""

REF_SHAPES = r"""
import json, sys
from repro.launch.dryrun import build_cell     # 512 host devices
import jax
from repro.launch.mesh import make_production_mesh
mesh = make_production_mesh(multi_pod=False)
out = {}
for cell in sys.argv[1:]:
    arch, shape = cell.split(":")
    fn, args, in_sh, _, _ = build_cell(arch, shape, mesh)
    def walk(t, sh, pre):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], sh[k], f"{pre}/{k}")
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for k, v, s in zip(t._fields, t, sh):
                walk(v, s, f"{pre}/{k}")
        elif isinstance(t, tuple):
            for i, (v, s) in enumerate(zip(t, sh)):
                walk(v, s, f"{pre}/{i}")
        else:
            out[f"{cell}{pre}"] = list(sh.shard_shape(t.shape))
    # the decode cell's last arg is its scalar position: not a port arg
    n = 3
    walk(tuple(args[:n]), tuple(in_sh[:n]), "")
print(json.dumps(out))
"""

CELLS = ["mamba2-130m:decode_32k", "qwen2.5-3b:train_4k",
         "granite-moe-3b-a800m:decode_32k"]


def test_local_shapes_match_reference_shard_shapes():
    port = run(PORT_SHAPES, *CELLS)
    ref = run(REF_SHAPES, *CELLS, jax=True)
    assert len(ref) > 40
    assert port == ref
    # something is split on both cells
    full = {"mamba2-130m:decode_32k/1/state": [24, 128, 24, 64, 128]}
    for k, v in full.items():
        assert port[k] != v and port[k][1] == 128 // 16


FLOPS = r"""
import json
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.distributed.sharding import Sharding
from repro_torch.launch import dryrun as D
mesh = D.production_mesh(False, torch.device("cpu"))
x = torch.empty(256, 4096, device="meta")
w = torch.empty(4096, 4096, device="meta")
res = {}
for name, wpl in (("tp", [Replicate(), Shard(1)]),
                  ("replicated", [Replicate(), Replicate()])):
    sh = (Sharding(mesh, (Shard(0), Replicate())), Sharding(mesh, tuple(wpl)))
    _, c, _ = D.measure(lambda a, b: a @ b, (x, w), sh, "cpu")
    res[name] = c.flops
with FakeTensorMode():
    a = D.fake_dtensor(x, Sharding(mesh, (Shard(0), Replicate())), "cpu")
    b = D.fake_dtensor(w, Sharding(mesh, (Replicate(), Shard(1))), "cpu")
    with FlopCounterMode(display=False) as fc:
        a @ b
    res["flop_counter_mode"] = fc.get_total_flops()
dist.destroy_process_group()
print(json.dumps(res))
"""


def test_flops_per_dev_counts_local_work():
    res = run(FLOPS)
    glob = 2 * 256 * 4096 * 4096
    # (16 rows) x (256 columns) of the product on rank 0
    assert res["tp"] == 2 * 16 * 4096 * 256 == glob // 256
    # the weight replicated over "model": the 16 rows' whole product, on
    # each of the 16 model ranks (global / 256 would undercount 16x)
    assert res["replicated"] == 2 * 16 * 4096 * 4096 == glob // 16
    # what FlopCounterMode around DTensor ops reports: the global op
    assert res["flop_counter_mode"] == glob


CALIBRATE = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist
from repro_torch.configs import get_smoke
from repro_torch.launch import calibrate as C
from repro_torch.launch.dryrun import production_mesh
arch, shape = sys.argv[1:3]
cfg = get_smoke(arch, layers=6)
if cfg.family == "encdec":
    cfg = dataclasses.replace(cfg, dec_layers=6)
rec = C.calibrate_cell(arch, shape, device="cpu", cfg=cfg)
mesh = production_mesh(False, torch.device("cpu"))
direct = C._measure(cfg, arch, shape, mesh, None, torch.device("cpu"))
dist.destroy_process_group()
print(json.dumps({"rec": rec, "direct": direct[:3]}))
"""


@pytest.mark.parametrize("cell", ["qwen2.5-3b:train_4k",
                                  "mamba2-130m:decode_32k",
                                  "whisper-tiny:decode_32k"])
def test_calibration_equals_direct_count(cell):
    res = run(CALIBRATE, *cell.split(":"))
    rec, direct = res["rec"], res["direct"]
    assert rec["status"] == "OK"
    assert (rec["points"]["a_layers"], rec["points"]["b_layers"]) == (2, 4)
    for i, k in enumerate(("flops", "bytes", "coll_wire")):
        assert rec[k] == pytest.approx(direct[i], rel=1e-12, abs=1e-6), k
    assert rec["flops"] > 0 and rec["flops_per_unit"] > 0
