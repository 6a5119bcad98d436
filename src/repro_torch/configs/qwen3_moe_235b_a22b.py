"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B family; hf-verified tier].

94L d_model=4096 64H (GQA kv=4) per-expert d_ff=1536 vocab=151936,
MoE 128 experts top-8.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, experts_per_token=8),
    moment_dtype="bfloat16",   # 235B: fp32 moments do not fit 16 GB/chip at 256 chips
)
