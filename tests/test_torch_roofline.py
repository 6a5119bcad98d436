"""The port's roofline (repro_torch/distributed/roofline.py) against the
reference's.

The three collectives of tests/test_system.py's HLO (an fp32 all-reduce
over 4 ranks, a bf16 all-gather over groups of 4, a u32 permute between
2 ranks) are issued as torch functional collectives on a fake 16-rank
process group (a subprocess, which blocks JAX and the JAX package) and
recorded by the dry run's dispatch mode. The records give the count and
the wire bytes per kind of the reference's parse_collectives on that
HLO, exactly. The port's ring formulas, its NVLink/NIC split (a group
inside one node of 8 consecutive ranks, or not) and its H100 terms are
held on records made by hand.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.distributed.roofline import parse_collectives as jparse  # noqa: E402
from repro_torch.distributed import roofline as R  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

HLO = """
  %ar = f32[128,256]{1,0} all-reduce(f32[128,256]{1,0} %x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = (bf16[64,64]{1,0}, bf16[256,64]{1,0}) all-gather-start(bf16[64,64]{1,0} %y), replica_groups=[4,4]<=[16], dimensions={0}
  %cp = u32[8]{0} collective-permute(u32[8]{0} %z), source_target_pairs={{0,1}}, replica_groups={{0,1}}
"""

RECORD = r"""
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".")
               for b in ("jax", "jaxlib", "repro")):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
import json
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.dryrun import Counter

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
g4 = dist.new_group([0, 1, 2, 3])
g2 = dist.new_group([0, 1])
with Counter() as c:
    funcol.all_reduce(torch.zeros(128, 256), "sum", g4)
    funcol.all_gather_tensor(torch.zeros(64, 64, dtype=torch.bfloat16), 0,
                             g4)
    funcol.permute_tensor(torch.zeros(8, dtype=torch.int32), [1, 0], g2)
dist.destroy_process_group()
print(json.dumps(c.collectives))
"""


@pytest.fixture(scope="module")
def records():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", RECORD], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_recorded_collectives(records):
    kinds = [r["kind"] for r in records]
    assert kinds == ["all-reduce", "all-gather", "collective-permute"]
    assert [r["group_size"] for r in records] == [4, 4, 2]
    assert records[0]["group_ranks"] == [0, 1, 2, 3]
    assert records[1]["result_bytes"] == 256 * 64 * 2
    assert records[1]["operand_bytes"] == 64 * 64 * 2


def test_wire_bytes_match_reference_parser(records):
    ref = jparse(HLO)
    got = R.parse_collectives(records)
    assert got.count == ref.count == 3
    assert {k: tuple(v) for k, v in got.by_kind.items()} == \
        {k: tuple(v) for k, v in ref.by_kind.items()}
    assert got.wire_bytes == ref.wire_bytes
    assert got.payload_bytes == ref.payload_bytes
    d = got.as_dict()
    assert set(d) >= set(ref.as_dict())
    assert d["by_kind"] == ref.as_dict()["by_kind"]


def _rec(kind, operand, result, ranks):
    return {"kind": kind, "operand_bytes": operand, "result_bytes": result,
            "group_size": len(ranks), "group_ranks": list(ranks)}


@pytest.mark.parametrize("kind,operand,result,want", [
    ("all-gather", 100, 1600, 1600 * 15 / 16),
    ("reduce-scatter", 1600, 100, 100 * 15),
    ("all-reduce", 800, 800, 2 * 800 * 15 / 16),
    ("all-to-all", 800, 800, 800 * 15 / 16),
    ("collective-permute", 64, 64, 64),
])
def test_ring_formulas(kind, operand, result, want):
    assert R.wire_bytes(_rec(kind, operand, result, range(16))) == want


def test_nvlink_and_nic_split_on_16_ranks():
    """On 16 ranks (two nodes of 8): a group inside one node rides
    NVLink, one across the two nodes the NIC, a group of one sends
    nothing."""
    assert R.link_of(range(8)) == "nvlink"
    assert R.link_of(range(8, 16)) == "nvlink"
    assert R.link_of(range(16)) == "nic"
    assert R.link_of([0, 8]) == "nic"
    recs = [_rec("all-reduce", 1 << 20, 1 << 20, range(8)),
            _rec("all-reduce", 1 << 20, 1 << 20, range(16)),
            _rec("all-gather", 1 << 10, 1 << 11, [3, 11]),
            _rec("all-reduce", 1 << 20, 1 << 20, [5])]
    st = R.parse_collectives(recs)
    assert st.count == 3
    nv = 2 * (1 << 20) * 7 / 8
    nic = 2 * (1 << 20) * 15 / 16 + (1 << 11) / 2
    assert st.by_link == {"nvlink": nv, "nic": nic}
    terms = R.roofline_terms(0.0, 0.0, st)
    assert terms["collective_s"] == nv / 450e9 + nic / 50e9


def test_h100_terms():
    st = R.parse_collectives([])
    t = R.roofline_terms(989e12, 3.35e12 / 2, st)
    assert t["compute_s"] == 1.0 and t["memory_s"] == 0.5
    assert t["collective_s"] == 0.0
    assert t["dominant"] == "compute" and t["step_lower_bound_s"] == 1.0
    assert t["compute_fraction_of_bound"] == 1.0
    assert set(t) == {"compute_s", "memory_s", "collective_s", "dominant",
                      "step_lower_bound_s", "compute_fraction_of_bound"}
    # the card's constants, not a TPU's
    assert (R.PEAK_FLOPS, R.HBM_BW, R.NVLINK_BW, R.NIC_BW, R.NODE_SIZE) == \
        (989e12, 3.35e12, 450e9, 50e9, 8)
