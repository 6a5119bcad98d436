"""Unified model facade (PyTorch): the dense, MoE, SSM, hybrid
(Zamba2), hybrid_moe (Granite-4.0-H, ``granite_hybrid``; its config is a
``GraniteHybridConfig``) and enc-dec families.

  init(generator, device)              -- a param dict drawn from a seed
  abstract_params / param_pspecs / param_shardings
                                       -- meta tensors, PartitionSpecs and
                                          (mesh, placements) per param
  loss(params, batch)                  -- mean next-token xent (+ MoE aux),
                                          differentiable (train_step target)
  prefill(params, inputs)              -- inference-prefill target
  decode_step(params, cache, token, pos)
  init_cache(batch, capacity, device)  -- enc-dec: capacity = encoder length
  input_specs(shape) / input_pspecs(shape, rules) / cache_axes()
                                       -- the inputs of a dry-run cell, as
                                          meta tensors and specs
  prefill_out_axes() / decode_cache(pre, rules)
                                       -- prefill's outputs' logical axes;
                                          the decode cache of a prefill
  kv_layers() / context_state(pre) / plan_config()
                                       -- what SparKV's server stores and
                                          plans over (dense, moe,
                                          hybrid_moe): the layers that
                                          hold K and V, a prefill cache
                                          split into (k, v, the rest), the
                                          planner's ModelConfig of the
                                          KV rows
  lay_out(tree, axes, rules)           -- DTensors laid out by logical axes

Each family module owns its cache layout (``init_cache``, ``cache_axes``,
``prefill_out_axes``, ``decode_cache``) and, where SparKV serves it,
``kv_layers`` and ``plan_config``; the facade delegates to it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve
from repro_torch.distributed.spmd import is_dtensor
from repro_torch.models import layers as L
from repro_torch.models import (encdec, granite_hybrid, hybrid, mamba_lm,
                                transformer)
from repro_torch.spans import span


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    _mod: Any

    # ---- params ----
    def param_defs(self):
        return self._mod.param_defs(self.cfg)

    def abstract_params(self):
        return L.abstract_params(self.param_defs())

    def param_pspecs(self, rules):
        return L.pspec_tree(self.param_defs(), rules)

    def param_shardings(self, rules):
        return L.sharding_tree(self.param_defs(), rules)

    def init(self, generator=0, *, device=None):
        """Random params on `device` (default: the card). `generator` is a
        torch.Generator on that device or an int seed."""
        dev = resolve(device)
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=dev).manual_seed(
                int(generator))
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, params on "
                             f"{dev}")
        return L.init_params(self.param_defs(), generator, dev)

    def loss(self, params, batch):
        return self._mod.loss_fn(self.cfg, params, batch)

    def prefill(self, params, inputs):
        if self.cfg.family == "encdec":
            return self._mod.prefill(self.cfg, params, inputs["frames"])
        return self._mod.prefill(self.cfg, params, inputs["tokens"])

    def decode_step(self, params, cache, token, pos):
        with span("decode.step"):
            return self._mod.decode_step(self.cfg, params, cache, token, pos)

    def init_cache(self, batch: int, capacity: int, *, device=None):
        return self._mod.init_cache(self.cfg, batch, capacity,
                                    device=resolve(device))

    def cache_axes(self):
        return self._mod.cache_axes(self.cfg)

    def prefill_out_axes(self):
        """The logical axes of prefill's outputs (the reference's
        launch/dryrun._prefill_out_axes): last-position logits (not an
        enc-dec's), and the cache leaves it returns."""
        return self._mod.prefill_out_axes(self.cfg)

    def decode_cache(self, pre: dict, rules=None) -> dict:
        """The decode cache of a prefill's cache `pre`: its leaves, and
        zeroed buffers for what decode writes (the attention tails; the
        enc-dec self-attention caches) in the dtype and on the device of
        the context K (DTensors laid out by cache_axes under `rules` when
        `pre` holds DTensors). The SSM state and conv window are
        prefill's own. Each family names and sizes its own buffers
        (``init_cache`` allocates the same)."""
        return self._mod.decode_cache(self.cfg, pre, rules)

    # ---- what SparKV's server stores and plans over ----
    def _sparkv(self, name: str):
        fn = getattr(self._mod, name, None)
        if fn is None:
            raise ValueError(f"SparKV serves dense, moe and hybrid_moe "
                             f"models, not {self.cfg.family}")
        return fn(self.cfg)

    def kv_layers(self) -> list:
        """The layers that hold K and V, in the order of the prefill
        cache's ``k``/``v`` rows and of the decode tails' rows."""
        return self._sparkv("kv_layers")

    def context_state(self, pre: dict) -> tuple:
        """A prefill's cache as (k, v, rest): K and V of the KV layers,
        each (len(kv_layers), b, s, hkv, hd), and whatever else the model
        carries past the context ({} for a transformer; a hybrid_moe's
        Mamba ``conv`` windows and ``state``s)."""
        return pre["k"], pre["v"], {n: t for n, t in pre.items()
                                    if n not in ("k", "v")}

    def plan_config(self) -> ModelConfig:
        """The ModelConfig SparKV's planner plans the (token-chunk, layer)
        grid of the KV rows with: the model's own for a transformer, a
        MoE transformer of the attention layers for a hybrid_moe."""
        return self._sparkv("plan_config")

    # ---- abstract inputs for a dry run (meta tensors) ----
    def input_specs(self, shape: ShapeConfig) -> dict:
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        meta = lambda sh, dt: torch.empty(sh, dtype=dt, device="meta")
        if cfg.family == "encdec" and shape.kind == "train":
            return {"frames": meta((b, s, cfg.d_model), torch.bfloat16),
                    "dec_tokens": meta((b, cfg.dec_len + 1), torch.int32)}
        if cfg.family == "encdec" and shape.kind == "prefill":
            return {"frames": meta((b, s, cfg.d_model), torch.bfloat16)}
        if shape.kind == "train":
            return {"tokens": meta((b, s + 1), torch.int32)}
        if shape.kind == "prefill":
            return {"tokens": meta((b, s), torch.int32)}
        # decode (enc-dec: cross-KV over s encoder states + self cache)
        return {"cache": self._mod.init_cache(cfg, b, s, device="meta"),
                "token": meta((b,), torch.int32),
                "pos": meta((), torch.int32)}

    def input_pspecs(self, shape: ShapeConfig, rules) -> dict:
        from repro_torch.distributed.sharding import PartitionSpec as P
        specs = self.input_specs(shape)
        by_name = {"tokens": ("batch", None), "dec_tokens": ("batch", None),
                   "frames": ("batch", "block_seq", None),
                   "token": ("batch",)}
        out: dict = {}
        for name, v in specs.items():
            if name in by_name:
                out[name] = rules.spec(by_name[name], v.shape)
            elif name == "pos":
                out[name] = P()
            elif name == "cache":
                out[name] = _map_cache(lambda t, ax: rules.spec(ax, t.shape),
                                       v, self.cache_axes())
            else:
                raise KeyError(name)
        return out

    def train_batch_shape(self, shape: ShapeConfig) -> dict:
        return self.input_specs(shape)


def lay_out(tree, axes, rules):
    """Each leaf of `tree` (dicts and tuples of tensors) laid out by its
    logical axes in the same-structured `axes` under `rules`: a DTensor
    redistributed (only where its placements differ), a plain tensor
    distributed (each rank keeps its own block, nothing is sent). The
    counterpart of a jitted function's out_shardings."""
    if isinstance(tree, dict):
        return {k: lay_out(v, axes[k], rules) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(lay_out(v, a, rules) for v, a in zip(tree, axes))
    want = rules.placements(axes, tree.shape)
    if not is_dtensor(tree):
        return rules.distribute(tree, axes)
    if tuple(tree.placements) == tuple(want):
        return tree
    return tree.redistribute(tree.device_mesh, want)


def _map_cache(fn, cache, axes):
    if isinstance(cache, dict):
        return {k: _map_cache(fn, cache[k], axes[k]) for k in cache}
    return fn(cache, axes)


_FAMILY_MODULES = {
    "dense": transformer,
    "moe": transformer,
    "hybrid": hybrid,
    "hybrid_moe": granite_hybrid,
    "ssm": mamba_lm,
    "encdec": encdec,
}


def build_model(cfg) -> Model:
    """The model of a ModelConfig, or of a GraniteHybridConfig (family
    hybrid_moe)."""
    return Model(cfg=cfg, _mod=_FAMILY_MODULES[cfg.family])
