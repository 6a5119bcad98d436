"""Gradient accumulation over a sharded batch: jit_train_step with
microbatches=2 on a (2, 2) ("data", "model") gloo mesh against
build_train_step with microbatches=2 on one rank (tests/torch_dist_worker.py's
"step" case), smoke configs, fp32, numpy-drawn weights, 2 steps.

Each microbatch must hold the global rows the reference's reshape and
scan give it, [i b/mb, (i+1) b/mb), on any mesh: the loss of a
microbatch is normalized by its own count of unmasked labels, and the MoE
router loss and capacity are computed over the tokens that share a
microbatch. The masked cases mask the last label of the first two of the
four rows, so that the two microbatches' normalizers differ (31 + 31
against 32 + 32 labels). The MoE family is held to the per-data-shard
semantics of tests/test_torch_distributed.py (capacity factor 8.0, the
router loss of each data shard averaged over the shards). Bounds as
there: loss within 1e-5, grad norm within 1e-5 of its size, params and
both moments within 1e-5 of each leaf's largest magnitude.
"""
import pytest

pytest.importorskip("torch")

from test_torch_sharded_serving import run_ranks  # noqa: E402

CASES = {"dense-masked": ("qwen2.5-3b", {}, 2),
         "moe": ("granite-moe-3b-a800m", {"moe": {"capacity_factor": 8.0}},
                 0),
         "moe-masked": ("granite-moe-3b-a800m",
                        {"moe": {"capacity_factor": 8.0}}, 2)}


@pytest.mark.parametrize("case", list(CASES))
def test_microbatched_sharded_step_matches_one_rank(case, tmp_path):
    arch, overrides, masked = CASES[case]
    res = run_ranks({"arch": arch, "mesh_shape": [2, 2],
                     "axes": ["data", "model"], "overrides": overrides,
                     "microbatches": 2, "masked": masked}, 4, tmp_path,
                    case="step")
    assert res["dtensors"] and res["count"] == 2
    for a, b in res["loss"]:
        assert abs(a - b) < 1e-5, res["loss"]
    for a, b in res["grad_norm"]:
        assert abs(a - b) <= 1e-5 * abs(b), res["grad_norm"]
    for k in ("params", "m", "v"):
        assert res["errs"][k] < 1e-5, res["errs"]
    assert any("Shard" in p for p in res["placements"].values())
