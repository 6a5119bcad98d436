"""The port's decoder-only transformer, dense and MoE: the configuration
file's ``model`` block is ``repro_torch``'s ``ModelConfig``, its ``moe``
group a ``MoEConfig``."""
from __future__ import annotations


def config(conf: dict):
    """The program's ModelConfig and SparKVConfig of a configuration."""
    from repro_torch.configs.base import ModelConfig, MoEConfig, SparKVConfig
    m = dict(conf["model"])
    if m.get("moe"):
        m["moe"] = MoEConfig(**m["moe"])
    return (ModelConfig(name=conf["name"], **m),
            SparKVConfig(**conf["sparkv"]))
