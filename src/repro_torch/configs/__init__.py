"""Architecture config registry.

``get_config(name)`` returns the full published config; ``get_smoke(name)``
returns a reduced same-family config for CPU smoke tests.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, ShapeConfig, TrainConfig, SparKVConfig,
    SHAPES, reduced,
)

_MODULES = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "chameleon-34b": "chameleon_34b",
    "starcoder2-3b": "starcoder2_3b",
    "gemma-2b": "gemma_2b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen2.5-3b": "qwen2_5_3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "whisper-tiny": "whisper_tiny",
    "mamba2-130m": "mamba2_130m",
    "sparkv-qwen3-4b": "sparkv_qwen3_4b",
}

# The 10 assigned architectures (dry-run / roofline coverage set).
ASSIGNED_ARCHS = [k for k in _MODULES if k != "sparkv-qwen3-4b"]


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_smoke(name: str, **kw) -> ModelConfig:
    return reduced(get_config(name), **kw)


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether a (arch, shape) cell runs, per assignment rules."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k skipped: pure full-attention arch (quadratic)"
    return True, ""
