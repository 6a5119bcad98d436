"""Unified model facade (PyTorch): the dense, MoE, SSM, hybrid and
enc-dec families.

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
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve
from repro_torch.models import layers as L
from repro_torch.models import encdec, hybrid, mamba_lm, transformer


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
        return self._mod.decode_step(self.cfg, params, cache, token, pos)

    def init_cache(self, batch: int, capacity: int, *, device=None):
        return self._mod.init_cache(self.cfg, batch, capacity,
                                    device=resolve(device))

    def cache_axes(self):
        return self._mod.cache_axes(self.cfg)

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


def _map_cache(fn, cache, axes):
    if isinstance(cache, dict):
        return {k: _map_cache(fn, cache[k], axes[k]) for k in cache}
    return fn(cache, axes)


_FAMILY_MODULES = {
    "dense": transformer,
    "moe": transformer,
    "hybrid": hybrid,
    "ssm": mamba_lm,
    "encdec": encdec,
}


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg, _mod=_FAMILY_MODULES[cfg.family])
