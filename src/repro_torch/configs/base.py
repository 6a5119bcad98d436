"""Config dataclasses for models, shapes, training, and SparKV.

Every assigned architecture gets one module in this package defining a
``CONFIG`` ModelConfig with the exact published hyperparameters, plus a
``reduced()`` helper that returns a CPU-smoke-testable shrink of the same
family.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    # capacity factor for the sort-based dropping dispatch
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD hyperparameters."""
    state_dim: int           # N (ssm_state)
    head_dim: int = 64       # P
    expand: int = 2          # d_inner = expand * d_model
    chunk_len: int = 256     # SSD chunk length
    conv_width: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec
    num_layers: int
    d_model: int
    num_heads: int               # query heads (0 for attn-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    activation: str = "swiglu"   # swiglu | geglu | gelu
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block applied every `attn_every`
    # mamba layers, re-using the same shared parameters each time.
    attn_every: int = 0
    # enc-dec (whisper): decoder depth & max decoder length
    dec_layers: int = 0
    dec_len: int = 448
    # modality frontend stub: none | audio_frames | vq_tokens
    frontend: str = "none"
    # True when the architecture's attention cost is sub-quadratic in context
    # (SSM/hybrid archs) — gates the long_500k shape.
    subquadratic: bool = False
    remat: str = "full"          # none | full | dots
    # dtype policy
    param_dtype: str = "bfloat16"
    moment_dtype: str = "float32"
    # chunk sizes of the memory-efficient reference paths. The cost-
    # calibration dry-run sets these to the full sequence so the inner
    # lax.scans disappear (XLA cost_analysis counts a scan body once —
    # see EXPERIMENTS.md §Roofline methodology).
    attn_chunk: int = 1024
    loss_chunk: int = 512
    # unroll factor for the layer scans (calibration sets = num_layers so
    # cost_analysis sees every layer's ops)
    scan_unroll: int = 1

    # ----- derived -----
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        assert self.num_heads > 0
        return self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to /128 so it shards over any mesh axis we use."""
        return _round_up(self.vocab_size, 128)

    @property
    def has_attention(self) -> bool:
        return self.num_heads > 0

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline math)."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe"):
            per_layer += self._attn_params()
            per_layer += self._ffn_params()
            n = self.num_layers * per_layer
        elif self.family == "ssm":
            n = self.num_layers * self._ssm_params()
        elif self.family == "hybrid":
            # mamba layers carry no FFN; one shared attn+FFN block
            n = self.num_layers * self._ssm_params()
            n += self._attn_params() + self._ffn_params()
        elif self.family == "encdec":
            enc = self.num_layers * (self._attn_params() + self._ffn_params())
            dec = self.dec_layers * (2 * self._attn_params() + self._ffn_params())
            n = enc + dec
        else:
            raise ValueError(self.family)
        return n + emb

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.num_layers * self._ffn_params()
        active_ffn = self.num_layers * self.moe.experts_per_token * (
            3 * d * self.d_ff)
        return dense + active_ffn

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        return q + kv + o

    def _ffn_params(self) -> int:
        d = self.d_model
        gated = self.activation in ("swiglu", "geglu")
        mats = 3 if gated else 2
        per_expert = mats * d * self.d_ff
        if self.moe is not None:
            return self.moe.num_experts * per_expert + d * self.moe.num_experts
        return per_expert

    def _ssm_params(self) -> int:
        """Matches models/ssm.py: B and C are shared across heads
        (ngroups=1), separate x/z/B/C/dt projections + depthwise conv."""
        assert self.ssm is not None
        d, n = self.d_model, self.ssm.state_dim
        d_inner = self.ssm.expand * d
        nheads = d_inner // self.ssm.head_dim
        in_proj = d * (2 * d_inner + 2 * n + nheads)
        out_proj = d_inner * d
        conv = self.ssm.conv_width * (d_inner + 2 * n)
        return in_proj + out_proj + conv + 2 * nheads + d_inner


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int


# The four assigned LM shapes (identical across the 10 archs).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1        # gradient accumulation
    seed: int = 0
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    grad_compression: str = "none"   # none | int8_ef


@dataclass(frozen=True)
class SparKVConfig:
    """SparKV scheduler / engine knobs (paper §IV)."""
    chunk_tokens: int = 1024
    # kernel block sizes — TPU adaptation: 128x128 MXU-aligned (paper: 128x64)
    q_block: int = 128
    kv_block: int = 128
    attention_mass: float = 0.98      # active-block CDF threshold
    stages: int = 8                   # K decision stages
    stage_budget_s: float = 0.25      # Δt per stage
    quant_bits: int = 5               # streamed-KV quantization (paper: 5-bit)
    quant_group: int = 64
    # runtime controller
    window_s: float = 0.2             # sliding monitor window
    max_migrations_per_stage: int = 32   # per monitor window
    imbalance_threshold: float = 1.15  # path-time ratio that triggers migration
    # priority weights (paper: equal by default)
    w_immediate: float = 1.0
    w_potential: float = 1.0
    scheduler_mode: str = "paper"     # paper (t,l,h) | engine (t,l)
    # per-chunk adaptive quantization: name of a
    # repro.compression.allocate schedule. "uniform" (default) disarms
    # the per-chunk machinery entirely — every trace is bit-identical to
    # a build without it; "flat" arms the per-chunk accounting while
    # still allocating quant_bits everywhere (byte-identical wire);
    # "attention"/"aggressive" spend bits where the saliency is.
    alloc_schedule: str = "uniform"


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
            heads: int = 4, kv_heads: Optional[int] = None, d_ff: int = 128,
            vocab: int = 512, experts: int = 8, state: int = 16) -> ModelConfig:
    """Shrink an arch config to a CPU-runnable smoke config of the same family."""
    kv = kv_heads if kv_heads is not None else max(1, min(cfg.num_kv_heads, heads))
    kw: dict = dict(
        num_layers=layers, d_model=d_model, d_ff=d_ff, vocab_size=vocab,
        num_heads=heads if cfg.num_heads > 0 else 0,
        num_kv_heads=kv if cfg.num_kv_heads > 0 else 0,
        head_dim=(d_model // heads) if cfg.num_heads > 0 else 0,
    )
    if cfg.moe is not None:
        kw["moe"] = replace(cfg.moe, num_experts=experts,
                            experts_per_token=min(cfg.moe.experts_per_token, 2))
    if cfg.ssm is not None:
        kw["ssm"] = replace(cfg.ssm, state_dim=state, head_dim=16,
                            chunk_len=16)
    if cfg.family == "hybrid":
        kw["attn_every"] = 2
    if cfg.family == "encdec":
        kw["dec_layers"] = 2
        kw["dec_len"] = 16
    return replace(cfg, name=cfg.name + "-smoke", **kw)
