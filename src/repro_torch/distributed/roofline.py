"""Roofline terms of one device's share of a step (PyTorch).

Port of ``repro/distributed/roofline.py``. The reference reads its
collectives from XLA's optimized HLO text; torch emits no HLO, so here
the input is a record of the ``_c10d_functional`` collectives a run
issued (``record_collective``, called by the dry run's dispatch mode on
every local op): kind, operand and result bytes, group size and the
group's ranks. Per-device wire bytes follow the reference's ring
formulas, unchanged:

    all-gather          out * (N-1)/N
    reduce-scatter      out * (N-1)         (out: the scattered block)
    all-reduce          2 * bytes * (N-1)/N  (RS + AG)
    all-to-all          bytes * (N-1)/N
    collective-permute  bytes

An all-to-all whose input goes whole to one peer (the way torch writes a
permute) is a collective-permute.

Hardware model: one NVIDIA H100 80GB HBM3 (SXM), power limit 700.00 W:
989 TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink 4 at 450 GB/s per
direction among the 8 GPUs of a node, and one 400 Gb/s NDR NIC (50 GB/s)
per GPU across nodes. Ranks are numbered node by node, 8 a node: a
group whose ranks all lie in one node is priced at the NVLink rate, any
other at the NIC rate (a ring is as slow as its slowest link).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

# NVIDIA H100 80GB HBM3 (SXM5), 700 W
PEAK_FLOPS = 989e12       # dense bf16 / GPU
HBM_BW = 3.35e12          # bytes/s / GPU
NVLINK_BW = 450e9         # bytes/s / GPU, per direction, within a node
NIC_BW = 50e9             # bytes/s / GPU across nodes (400 Gb/s NDR)
NODE_SIZE = 8             # GPUs a node (consecutive ranks)

_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}


def _tensors(x):
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def group_ranks(group_name: str) -> list:
    """The global ranks of a process group, by its registered name."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    return list(dist.get_process_group_ranks(
        _resolve_process_group(group_name)))


def record_collective(func, args, kwargs, out):
    """One collective's record, or None when `func` is not a functional
    collective (``wait_tensor`` included: the collective was recorded
    when it was issued)."""
    if getattr(func, "namespace", None) != "_c10d_functional":
        return None
    kind = _KINDS.get(func._overloadpacket.__name__)
    if kind is None:
        return None
    schema = [a.name for a in func._schema.arguments]
    named = dict(zip(schema, args), **(kwargs or {}))
    ranks = group_ranks(named["group_name"])
    first = schema[0]
    operand = _nbytes(_tensors(named[first]))
    result = _nbytes(_tensors(out))
    if kind == "all-to-all":
        splits = named.get("input_split_sizes") or []
        if sum(1 for s in splits if int(s)) == 1:
            kind = "collective-permute"
    return {"kind": kind, "operand_bytes": operand, "result_bytes": result,
            "group_size": len(ranks), "group_ranks": ranks}


def link_of(ranks) -> str:
    """"nvlink" for a group inside one node, else "nic"."""
    return "nvlink" if len({r // NODE_SIZE for r in ranks}) == 1 else "nic"


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0            # per-device, modeled
    payload_bytes: float = 0.0         # per-device result bytes
    count: int = 0
    by_kind: dict = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: [0, 0.0]))
    # per-device wire bytes by the link that carries them
    by_link: dict = dataclasses.field(
        default_factory=lambda: {"nvlink": 0.0, "nic": 0.0})

    def as_dict(self):
        return {
            "wire_bytes": self.wire_bytes,
            "payload_bytes": self.payload_bytes,
            "count": self.count,
            "by_kind": {k: {"count": c, "wire_bytes": b}
                        for k, (c, b) in self.by_kind.items()},
            "by_link": dict(self.by_link),
        }


def wire_bytes(rec) -> float:
    n = rec["group_size"]
    kind = rec["kind"]
    out = max(rec["operand_bytes"], rec["result_bytes"])
    if kind == "all-gather":
        return out * (n - 1) / n
    if kind == "reduce-scatter":
        return min(rec["operand_bytes"], rec["result_bytes"]) * (n - 1)
    if kind == "all-reduce":
        return 2 * out * (n - 1) / n
    if kind == "all-to-all":
        return out * (n - 1) / n
    return out                      # collective-permute, broadcast


def parse_collectives(records) -> CollectiveStats:
    """The records of ``record_collective`` -> per-device stats."""
    stats = CollectiveStats()
    for rec in records:
        if rec["group_size"] <= 1:
            continue
        wire = wire_bytes(rec)
        stats.wire_bytes += wire
        stats.payload_bytes += rec["result_bytes"]
        stats.count += 1
        ent = stats.by_kind[rec["kind"]]
        ent[0] += 1
        ent[1] += wire
        stats.by_link[link_of(rec["group_ranks"])] += wire
    return stats


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll: CollectiveStats) -> dict:
    compute_t = flops_per_dev / PEAK_FLOPS
    memory_t = bytes_per_dev / HBM_BW
    collective_t = (coll.by_link["nvlink"] / NVLINK_BW
                    + coll.by_link["nic"] / NIC_BW)
    terms = {"compute_s": compute_t, "memory_s": memory_t,
             "collective_s": collective_t}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    return {
        **terms,
        "dominant": dom.replace("_s", ""),
        "step_lower_bound_s": bound,
        # roofline fraction if perfectly overlapped: useful-compute share
        "compute_fraction_of_bound": compute_t / bound if bound else 0.0,
    }
