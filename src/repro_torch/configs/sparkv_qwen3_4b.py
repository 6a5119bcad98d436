"""The paper's own primary evaluation model: Qwen3-4B [arXiv:2505.09388; hf].

36L d_model=2560 32H (GQA kv=8, head_dim=128) d_ff=9728 vocab=151936.
Used for the paper-faithful SparKV benchmarks (Figs. 9-16, Tables I-II).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="sparkv-qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
