"""starcoder2-3b [arXiv:2402.19173; hf].

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152 — GQA, RoPE.
StarCoder2 uses a standard (non-gated) GELU MLP and LayerNorm with bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    activation="gelu",
    norm="layernorm",
    qkv_bias=True,
    rope_theta=100_000.0,
    tie_embeddings=True,
)
