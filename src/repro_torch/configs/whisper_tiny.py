"""whisper-tiny [arXiv:2212.04356; unverified tier].

4L encoder + 4L decoder, d_model=384 6H (kv=6) d_ff=1536 vocab=51865.
Enc-dec; the conv audio frontend is a STUB — input_specs() provides
precomputed frame embeddings (batch, seq, d_model) directly.
Sinusoidal-absolute positions in the original; we feed positionless frame
embeddings (stub responsibility) + learned decoder positions via RoPE-free
attention — backbone only per assignment.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    activation="gelu",
    norm="layernorm",
    qkv_bias=True,
    tie_embeddings=True,
    dec_layers=4,
    dec_len=448,
    frontend="audio_frames",
)
