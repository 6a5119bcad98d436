"""A tiny cell for CPU runs of the harness: a 2-layer model of the
configurations' family at a smoke size, a 64-token context in chunks of
32, short prompts, the limits of a real cell."""
import json
from pathlib import Path

from cardbench import harness

ROOT = Path(__file__).resolve().parents[2]


def cell(policy="sparkv", moe=False, max_new=6, limits_of="qwen3-4b-l1.hotpotqa-stream"):
    model = {"family": "moe" if moe else "dense", "num_layers": 2,
             "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
             "head_dim": 16, "d_ff": 128, "vocab_size": 512,
             "activation": "swiglu", "norm": "rmsnorm",
             "rope_theta": 10000.0, "tie_embeddings": True,
             "param_dtype": "bfloat16"}
    if moe:
        model["moe"] = {"num_experts": 8, "experts_per_token": 2,
                        "capacity_factor": 1.25}
    config = {"name": "tiny-moe" if moe else "tiny",
              "program": "transformer", "reference": "transformer",
              "model": model,
              "sparkv": {"chunk_tokens": 32, "quant_bits": 5,
                         "quant_group": 32, "q_block": 16, "kv_block": 16,
                         "alloc_schedule": "uniform"},
              "profile": "jetson-orin"}
    workload = {"policy": policy, "network": "campus-wifi", "contexts": 1,
                "context_tokens": 64, "prompt_lengths": [3, 5, 7],
                "max_new": max_new}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    limits = json.loads((ROOT / "cardbench" / "limits"
                         / f"{limits_of}.json").read_text())["limits"]
    return harness.Cell(name="tiny", chips=1, workload=workload,
                        config=config, limits=limits,
                        end_to_end=bench["end_to_end"],
                        per_layer=bench["per_layer"])
