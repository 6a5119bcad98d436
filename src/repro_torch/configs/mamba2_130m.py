"""mamba2-130m [arXiv:2405.21060; unverified tier].

24L d_model=768 attention-free, vocab=50280, ssm_state=128 — SSD
(state-space duality). Sub-quadratic: runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    norm="rmsnorm",
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_len=256),
    subquadratic=True,
    tie_embeddings=True,
)
