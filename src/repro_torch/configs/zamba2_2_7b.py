"""zamba2-2.7b [arXiv:2411.15242; hf].

54 Mamba2 layers, d_model=2560, plus a *shared* attention block (32H, kv=32,
head_dim=80) applied every 6 mamba layers re-using the same parameters
(Zamba's shared-transformer-block design), d_ff=10240, vocab=32000,
ssm_state=64. Sub-quadratic: runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    activation="gelu",
    norm="rmsnorm",
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk_len=128),
    attn_every=6,
    subquadratic=True,
    tie_embeddings=True,
)
