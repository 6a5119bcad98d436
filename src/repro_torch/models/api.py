"""Unified model facade (PyTorch), dense family.

  init(generator, device)              -- a param dict drawn from a seed
  prefill(params, inputs)              -- inference-prefill target
  decode_step(params, cache, token, pos)
  init_cache(batch, capacity, device)

Other families of ``repro.models.api`` are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import layers as L
from repro_torch.models import transformer


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    _mod: Any

    def param_defs(self):
        return self._mod.param_defs(self.cfg)

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

    def prefill(self, params, inputs):
        return self._mod.prefill(self.cfg, params, inputs["tokens"])

    def decode_step(self, params, cache, token, pos):
        return self._mod.decode_step(self.cfg, params, cache, token, pos)

    def init_cache(self, batch: int, capacity: int, *, device=None):
        return self._mod.init_cache(self.cfg, batch, capacity,
                                    device=resolve(device))


_FAMILY_MODULES = {"dense": transformer}


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILY_MODULES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ROADMAP.md, "
            "queue 1, item 10)")
    return Model(cfg=cfg, _mod=_FAMILY_MODULES[cfg.family])
