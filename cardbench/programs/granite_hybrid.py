"""The port's Granite-4.0-H family (``models.granite_hybrid``). The
configuration file's ``model`` block is ``repro_torch``'s ``ModelConfig``
(its ``moe`` and ``ssm`` groups a ``MoEConfig`` and an ``SSMConfig``) with
the ``GraniteHybridConfig`` fields beside it, and ``num_hidden_layers``,
the published name of the depth the cut changes. The file's top level
holds the published config.json as run; the program computes the
settings of it that ``FIXED`` names and refuses other values."""
from __future__ import annotations

FIXED = {"hidden_act": "silu", "normalization_function": "rmsnorm",
         "position_embedding_type": "nope", "attention_bias": False,
         "mamba_proj_bias": False, "mamba_conv_bias": True,
         "mamba_n_groups": 1, "tie_word_embeddings": True}
EXTRAS = ("shared_d_ff", "embedding_multiplier", "attention_multiplier",
          "residual_multiplier", "logits_scaling", "norm_eps")


def config(conf: dict):
    """The program's GraniteHybridConfig and SparKVConfig of a
    configuration."""
    from repro_torch.configs.base import (ModelConfig, MoEConfig, SSMConfig,
                                          SparKVConfig)
    from repro_torch.models.granite_hybrid import GraniteHybridConfig
    other = {k: conf[k] for k in FIXED if conf[k] != FIXED[k]}
    if other:
        raise ValueError(f"the program computes {FIXED}; got {other}")
    m = dict(conf["model"])
    if m.pop("num_hidden_layers") != m["num_layers"]:
        raise ValueError("num_layers and num_hidden_layers differ")
    extras = {k: m.pop(k) for k in EXTRAS}
    types = tuple(m.pop("layer_types"))
    m["moe"] = MoEConfig(**m["moe"])
    m["ssm"] = SSMConfig(**m["ssm"])
    cfg = GraniteHybridConfig(base=ModelConfig(name=conf["name"], **m),
                              layer_types=types, **extras)
    return cfg, SparKVConfig(**conf["sparkv"])
