"""chameleon-34b [arXiv:2405.09818; unverified tier].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.
Early-fusion VLM: VQ image tokens share the text vocabulary, so the backbone
is a plain decoder-only LM; the VQ tokenizer frontend is a stub
(input_specs() provides token ids that may include image-token ids).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="dense",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    activation="swiglu",
    norm="rmsnorm",
    frontend="vq_tokens",
)
