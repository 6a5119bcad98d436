"""A tiny configuration of the Granite-4.0-H family for CPU runs: 10
layers with attention at 5 (one period, as the benchmark's), 4/2 heads of
16, 8 experts of 32 (top 2) and a shared expert of 48, 8 Mamba heads of 16
whose gated norm spans all 128 channels, Granite's multipliers; a 64-token
context in chunks of 32, short prompts, the limits of the real cell."""
import json
from pathlib import Path

from cardbench import harness
from cardbench.programs.granite_hybrid import FIXED

ROOT = Path(__file__).resolve().parents[2]
CELL = "granite-4h-small-l10.hotpotqa-stream"


def conf() -> dict:
    return {"name": "tiny-granite", **FIXED,
            "program": "granite_hybrid", "reference": "granite_hybrid",
            "model": {
                "family": "hybrid_moe", "num_layers": 10,
                "num_hidden_layers": 10,
                "layer_types": ["mamba"] * 5 + ["attention"]
                + ["mamba"] * 4,
                "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
                "head_dim": 16, "d_ff": 32, "shared_d_ff": 48,
                "vocab_size": 500, "activation": "swiglu",
                "norm": "rmsnorm", "tie_embeddings": True,
                "param_dtype": "bfloat16",
                "moe": {"num_experts": 8, "experts_per_token": 2,
                        "capacity_factor": 4.0},
                "ssm": {"state_dim": 16, "head_dim": 16, "expand": 2,
                        "chunk_len": 16, "conv_width": 4},
                "embedding_multiplier": 12.0,
                "attention_multiplier": 0.0625,
                "residual_multiplier": 0.22, "logits_scaling": 16.0,
                "norm_eps": 1e-5},
            "sparkv": {"chunk_tokens": 32, "quant_bits": 5,
                       "quant_group": 32, "q_block": 16, "kv_block": 16,
                       "alloc_schedule": "uniform"},
            "profile": "jetson-orin"}


def cell(policy="sparkv", max_new=6) -> harness.Cell:
    """The tiny model under the real cell's limits and per-layer
    metrics."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mine = lambda ms: [m for m in ms if CELL in m.get("workloads", [CELL])]
    workload = {"policy": policy, "network": "campus-wifi", "contexts": 1,
                "context_tokens": 64, "prompt_lengths": [3, 5, 7],
                "max_new": max_new}
    limits = json.loads((ROOT / "cardbench" / "limits"
                         / f"{CELL}.json").read_text())["limits"]
    return harness.Cell(name="tiny-granite", chips=1, workload=workload,
                        config=conf(), limits=limits,
                        end_to_end=mine(bench["end_to_end"]),
                        per_layer=mine(bench["per_layer"]))
