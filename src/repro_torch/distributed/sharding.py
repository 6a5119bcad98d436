"""Logical-axis sharding resolver with divisibility-aware fallback, over a
torch ``DeviceMesh`` (PyTorch).

Port of ``repro/distributed/sharding.py``. Models annotate every
parameter / activation dim with a *logical* name ("embed", "heads",
"mlp", ...). A :class:`Rules` object maps logical names to an ordered
tuple of mesh axes; at resolution time the longest prefix of that tuple
whose size product divides the dim is used (otherwise the dim is
replicated), exactly as in the reference.

Where the reference hands a ``PartitionSpec`` to GSPMD, the port turns
it into DTensor placements, one per mesh dimension: a tensor dim split
over the mesh axes (a1, a2, ...) is ``Shard(dim)`` on each of them, split
major-to-minor in the spec's order as JAX splits it. Where that order is
not the mesh's own (``("model", "data")`` on a ("data", "model") mesh),
the earlier mesh dims take ``_StridedShard`` with the split factor of the
axes that precede them in the spec, which is DTensor's way to write a
right-to-left split.

The rules are carried in a contextvar so model code can call
``constrain(x, *names)`` without threading the mesh everywhere. Outside a
rules context, or on a plain tensor, ``constrain`` is the identity; on a
DTensor it redistributes to the rules' placements (the counterpart of
``with_sharding_constraint``).

``Rules`` takes a torch ``DeviceMesh`` (read through ``mesh_dim_names``
and its shape) or any object with ``axis_names`` and a ``shape`` dict
(the tests' stub of a production mesh, which needs no process group).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Sequence

from repro_torch.distributed.spmd import is_dtensor


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh axis name, or a tuple of
    names (major to minor). A tuple, so it compares with JAX's ``P``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or of a stub with a shape dict."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh_axis_names(mesh), tuple(mesh.shape)))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """The port's ``NamedSharding``: a mesh and one placement per mesh
    dim. Not a tuple, so a tree of them has one leaf per param."""
    mesh: object
    placements: tuple


@dataclasses.dataclass(frozen=True)
class Rules:
    mesh: object
    table: dict[str, tuple[str, ...]]
    weight_stationary: bool = False
    # logical names that were requested but fell back to replication
    # (filled lazily; dict for mutation despite frozen dataclass)
    fallbacks: dict = dataclasses.field(default_factory=dict)

    @property
    def n_devices(self) -> int:
        return self.axis_size(mesh_axis_names(self.mesh))

    def axis_size(self, axes: Sequence[str]) -> int:
        shape = mesh_shape(self.mesh)
        s = 1
        for a in axes:
            s *= shape[a]
        return s

    def resolve(self, name: Optional[str], size: int,
                used: set[str]) -> Optional[tuple[str, ...]]:
        """Longest prefix of the candidate axes that divides `size` and does
        not collide with axes already used by other dims of this tensor."""
        if name is None:
            return None
        cand = self.table.get(name, ())
        best: tuple[str, ...] = ()
        for i in range(len(cand), 0, -1):
            prefix = cand[:i]
            if any(a in used for a in prefix):
                continue
            if size % self.axis_size(prefix) == 0 and self.axis_size(prefix) > 1:
                best = prefix
                break
        if not best:
            if cand:
                self.fallbacks.setdefault(name, size)
            return None
        return best

    def spec(self, names: Sequence[Optional[str]],
             shape: Sequence[int]) -> PartitionSpec:
        assert len(names) == len(shape), (names, shape)
        used: set[str] = set()
        parts = []
        for n, s in zip(names, shape):
            r = self.resolve(n, s, used)
            if r is None:
                parts.append(None)
            else:
                used.update(r)
                parts.append(r if len(r) > 1 else r[0])
        return PartitionSpec(*parts)

    def placements(self, names: Sequence[Optional[str]],
                   shape: Sequence[int]) -> tuple:
        return spec_placements(self.mesh, self.spec(names, shape))

    def sharding(self, names: Sequence[Optional[str]],
                 shape: Sequence[int]) -> Sharding:
        return Sharding(self.mesh, self.placements(names, shape))

    def distribute(self, x, names: Sequence[Optional[str]]):
        """A full tensor, the same on every rank -> the DTensor laid out by
        `names`; each rank keeps its own block, nothing is sent."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(x, self.mesh, self.placements(names, x.shape),
                                 src_data_rank=None)


def spec_placements(mesh, spec: Sequence) -> tuple:
    """A PartitionSpec -> one DTensor placement per mesh dim.

    Tensor dim d split over axes (a1, ..., ak), major to minor, is
    Shard(d) on each. DTensor splits a dim over its mesh dims left to
    right (the mesh's order is major to minor); a mesh dim whose axis
    comes later in the spec than an axis of a later mesh dim takes
    _StridedShard(d, split_factor=product of those later dims' sizes)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    names = mesh_axis_names(mesh)
    shape = mesh_shape(mesh)
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        for i, a in enumerate(axes):
            mi = names.index(a)
            # axes more major in the spec that the mesh splits later
            sf = 1
            for b in axes[:i]:
                if names.index(b) > mi:
                    sf *= shape[b]
            out[mi] = _StridedShard(d, split_factor=sf) if sf > 1 else Shard(d)
    return tuple(out)


_RULES: contextvars.ContextVar[Optional[Rules]] = contextvars.ContextVar(
    "repro_torch_sharding_rules", default=None)


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    tok = _RULES.set(rules)
    try:
        yield rules
    finally:
        _RULES.reset(tok)


def current_rules() -> Optional[Rules]:
    return _RULES.get()


def constrain(x, *names: Optional[str]):
    """Redistribute a DTensor to the placements of logical dim names (the
    reference's with_sharding_constraint); the identity without rules or
    on a plain tensor."""
    rules = _RULES.get()
    if rules is None or not is_dtensor(x):
        return x
    want = rules.placements(list(names), x.shape)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def make_rules(cfg, mesh, *, sp_activations: bool = False,
               weight_stationary: bool = False) -> Rules:
    """Build the per-arch logical→mesh table.

    Decisions (see DESIGN.md §4):
      - heads/kv_heads/mlp/experts prefer the "model" axis (tensor/expert
        parallelism); divisibility fallback handles awkward head counts.
      - when q-heads do NOT divide the model axis, attention falls back to
        sequence parallelism: the "seq" logical axis maps to "model".
      - batch maps to ("pod", "data"); FSDP ("embed_fsdp") to ("pod", "data").
      - `sp_activations`: additionally shard inter-block activations by seq
        (Megatron-SP; a §Perf lever) — only meaningful with head-sharded attn.
    """
    axes = mesh_axis_names(mesh)
    shape = mesh_shape(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in axes)
    model_ax = ("model",) if "model" in axes else ()

    msize = shape["model"] if "model" in axes else 1
    heads_shardable = cfg.num_heads > 0 and cfg.num_heads % max(msize, 1) == 0
    kv_shardable = (cfg.num_kv_heads > 0
                    and cfg.num_kv_heads % max(msize, 1) == 0)
    experts_shardable = (cfg.moe is not None
                         and cfg.moe.num_experts % max(msize, 1) == 0)

    # weight-stationary (decode/serving) layout: weights never travel;
    # the d_ff/expert dims spread over model x data and the (tiny at
    # decode) partial activations are summed instead. Dense archs keep
    # the FSDP layout, as in the reference.
    if weight_stationary and cfg.moe is not None:
        fsdp_axes: tuple = ()
        mlp_axes = data_axes if experts_shardable else model_ax + data_axes
    else:
        fsdp_axes = data_axes
        mlp_axes = () if experts_shardable else model_ax

    table: dict[str, tuple[str, ...]] = {
        "batch": data_axes,
        "vocab": model_ax,
        "embed": (),                 # weight embed dim: see embed_fsdp
        "embed_fsdp": fsdp_axes,     # FSDP shard of weight embed dims
        "heads": model_ax if heads_shardable else (),
        "kv_heads": model_ax if kv_shardable else (),
        "head_dim": (),
        "mlp": mlp_axes,
        "experts": model_ax if experts_shardable else (),
        "expert_cap": data_axes,     # MoE dispatch-buffer capacity dim
        "ssm_pdim": model_ax,        # mamba head_dim channels
        "ssm_heads": (),
        "state": (),
        "conv": (),
        "layers": (),
        # activations
        "seq": () if heads_shardable else model_ax,
        # residual-stream seq dim between blocks (Megatron-SP lever)
        "block_seq": model_ax if (sp_activations or not heads_shardable) else (),
        "act_heads": model_ax if heads_shardable else (),
        "act_kv": model_ax if kv_shardable else (),
        "act_mlp": () if experts_shardable else model_ax,
        "act_vocab": model_ax,
        # KV-cache seq dim: shard over model whenever kv heads cannot
        "kv_seq": () if kv_shardable else model_ax,
    }
    return Rules(mesh=mesh, table=table,
                 weight_stationary=weight_stationary)
