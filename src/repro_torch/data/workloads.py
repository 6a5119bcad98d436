"""Context-reuse workload synthesis.

Produces per-chunk statistics with the heterogeneity the paper measures:
  - attention sparsity per (t, l, h): heads draw a *pattern type*
    (diagonal / block-local / global / mixed — Fig. 2), giving active-block
    counts with a 15-20x spread (Fig. 3);
  - KV value entropy per (l, h): 0-4 bits/value spread -> compressed chunk
    sizes varying by several x (Fig. 4/5).

Dataset profiles mirror the paper's evaluation set (Table III): mean
context length and modality mix shift the sparsity/entropy distributions
(video workloads are denser + higher-entropy, code is more repetitive).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetProfile:
    name: str
    mean_len: int                 # tokens
    quality_metric: str
    sparsity_scale: float = 1.0   # multiplies active-block fraction
    entropy_shift: float = 0.0    # shifts per-head entropy (bits)
    seed: int = 0


DATASETS: dict[str, DatasetProfile] = {
    "repobench-p": DatasetProfile("repobench-p", 10_000, "edit_sim",
                                  sparsity_scale=0.8, entropy_shift=-0.5,
                                  seed=1),
    "hotpotqa": DatasetProfile("hotpotqa", 11_000, "f1", seed=2),
    "triviaqa": DatasetProfile("triviaqa", 11_000, "f1", seed=3),
    "longchat": DatasetProfile("longchat", 12_000, "accuracy", seed=4),
    "govreport": DatasetProfile("govreport", 13_000, "rouge_l",
                                sparsity_scale=1.1, seed=5),
    "narrativeqa": DatasetProfile("narrativeqa", 18_000, "f1", seed=6),
    "academic": DatasetProfile("academic", 28_000, "accuracy",
                               sparsity_scale=1.05, seed=7),
    "financial": DatasetProfile("financial", 49_000, "accuracy",
                                sparsity_scale=0.9, seed=8),
    "videomme": DatasetProfile("videomme", 23_000, "accuracy",
                               sparsity_scale=1.35, entropy_shift=0.6,
                               seed=9),
}

_PATTERNS = ("diagonal", "block", "global", "mixed")
_PATTERN_FRACS = {
    # base fraction of causal-valid kv blocks that are active per q row
    # (calibrated so sparse attention gives the paper's ~2.5x over full)
    "diagonal": 0.10, "block": 0.25, "global": 0.62, "mixed": 0.38,
}


@dataclasses.dataclass
class WorkloadChunks:
    """Per-chunk statistics for one request context."""
    n_t: int
    n_l: int
    n_h: int
    active_blocks: np.ndarray     # (n_t, n_l, n_h) float — per 1024-chunk
    entropy_bits: np.ndarray      # (n_l, n_h) float bits/value
    chunk_bytes: np.ndarray       # (n_t, n_l, n_h) float compressed size
    head_pattern: np.ndarray      # (n_l, n_h) int index into _PATTERNS
    context_len: int
    chunk_tokens: int

    def total_bytes(self) -> float:
        return float(self.chunk_bytes.sum())


def synthesize(cfg, context_len: int, dataset: DatasetProfile,
               *, chunk_tokens: int = 1024, kv_block: int = 128,
               quant_bits: int = 5, rng=None) -> WorkloadChunks:
    """Generate chunk stats for a context of `context_len` tokens."""
    rng = rng or np.random.default_rng(dataset.seed * 7919 + context_len)
    n_t = max(1, context_len // chunk_tokens)
    n_l = cfg.num_layers
    n_h = max(cfg.num_kv_heads, 1)
    hd = cfg.resolved_head_dim if cfg.num_heads else 64

    # head pattern assignment: shallow layers lean local, deep lean global
    pat = np.empty((n_l, n_h), np.int64)
    for l in range(n_l):
        depth = l / max(n_l - 1, 1)
        probs = np.array([
            0.45 - 0.25 * depth,          # diagonal
            0.30,                         # block
            0.05 + 0.30 * depth,          # global
            0.20 - 0.05 * depth,
        ])
        probs /= probs.sum()
        pat[l] = rng.choice(4, size=n_h, p=probs)

    # per-head multiplicative jitter, stable across t (head identity)
    head_jitter = np.exp(rng.normal(0, 0.35, size=(n_l, n_h)))

    # active blocks per chunk: fraction of causal-valid kv blocks
    blocks_per_chunk_row = chunk_tokens // 128   # q rows of 128
    active = np.zeros((n_t, n_l, n_h))
    for t in range(n_t):
        valid_kv_blocks = ((t + 1) * chunk_tokens) // kv_block
        for p_idx, p_name in enumerate(_PATTERNS):
            mask = pat == p_idx
            if not mask.any():
                continue
            frac = _PATTERN_FRACS[p_name] * dataset.sparsity_scale
            base = frac * valid_kv_blocks * blocks_per_chunk_row
            local_floor = blocks_per_chunk_row * min(
                8, valid_kv_blocks)     # always-kept local/sink blocks
            vals = base * head_jitter[mask] * np.exp(
                rng.normal(0, 0.10, mask.sum()))
            active[t][mask] = np.maximum(vals, local_floor)
    # cap at fully-dense
    for t in range(n_t):
        dense = ((t + 1) * chunk_tokens // kv_block) * blocks_per_chunk_row
        active[t] = np.minimum(active[t], dense)

    # entropy per (l, h): bimodal-ish 0-4 bits (Fig. 4), video shifted up
    base_e = np.clip(rng.normal(2.2 + dataset.entropy_shift, 0.9,
                                size=(n_l, n_h)), 0.05, quant_bits - 0.2)
    flat = rng.random((n_l, n_h)) < 0.12      # near-constant heads
    entropy = np.where(flat, rng.uniform(0.02, 0.3, (n_l, n_h)), base_e)

    # compressed bytes per chunk: tokens * hd * 2 (K and V) * e/8 + header
    values = chunk_tokens * hd * 2
    chunk_bytes = np.broadcast_to(
        values * entropy / 8.0, (n_t, n_l, n_h)).copy()
    chunk_bytes *= np.exp(rng.normal(0, 0.05, chunk_bytes.shape))
    chunk_bytes += 2 * 2 * (values // 64) + 64      # group scales + header

    return WorkloadChunks(n_t=n_t, n_l=n_l, n_h=n_h,
                          active_blocks=active, entropy_bits=entropy,
                          chunk_bytes=chunk_bytes, head_pattern=pat,
                          context_len=n_t * chunk_tokens,
                          chunk_tokens=chunk_tokens)


def sample_profiling_features(rng: np.random.Generator, n: int,
                              *, max_t: int = 40, chunk_tokens: int = 1024,
                              kv_block: int = 128):
    """(t, active_blocks) pairs drawn from the same generative family as
    synthesize() — the latency predictor's offline profiling distribution
    must match deployment workloads (paper §IV-C trains on real profiling
    runs)."""
    t = rng.integers(0, max_t, n).astype(np.float64)
    rows = chunk_tokens // 128
    fracs = np.array(list(_PATTERN_FRACS.values()))
    pick = fracs[rng.integers(0, len(fracs), n)]
    jitter = np.exp(rng.normal(0, 0.37, n))
    valid = (t + 1) * chunk_tokens / kv_block
    s = np.minimum(pick * jitter * valid * rows, valid * rows)
    floor = rows * np.minimum(8, valid)
    s = np.maximum(s, floor)
    return t, s


def lm_token_batch(rng: np.random.Generator, vocab: int, batch: int,
                   seq: int, *, motif_len: int = 64,
                   n_motifs: int = 32,
                   motif_seed: Optional[int] = None) -> np.ndarray:
    """Synthetic LM training data with repeated motifs (compressible,
    non-trivial loss curve).

    ``motif_seed`` pins the motif bank independently of ``rng``: a training
    loop that draws a fresh ``rng`` per step must pass it, otherwise every
    step sees brand-new motifs and the only learnable structure is the
    (uniform) unigram distribution — loss then never improves.
    """
    motif_rng = (np.random.default_rng(motif_seed)
                 if motif_seed is not None else rng)
    motifs = motif_rng.integers(0, vocab, size=(n_motifs, motif_len))
    out = np.empty((batch, seq), np.int64)
    for b in range(batch):
        pos = 0
        while pos < seq:
            if rng.random() < 0.7:
                m = motifs[rng.integers(n_motifs)]
                take = min(motif_len, seq - pos)
                out[b, pos:pos + take] = m[:take]
                pos += take
            else:
                take = min(int(rng.integers(8, 32)), seq - pos)
                out[b, pos:pos + take] = rng.integers(0, vocab, take)
                pos += take
    return out
