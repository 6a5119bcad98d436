"""The port's CheckpointManager against the reference's: a checkpoint of
{"params", "opt"} written by either package restores in the other bit
for bit (bf16 params, fp32 moments, the int32 step count), then the
commit protocol: retention, leftover tmp directories, the host copy
taken before the background write."""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.checkpoint.manager import CheckpointManager as JCM  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import TrainConfig, get_smoke  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

ARCH = "whisper-tiny"
CPU = "cpu"


def _bits(a):
    """A leaf's bytes as an integer array of its width."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a).reshape(-1).view(np.uint8)


def _assert_same(port, ref):
    pl, rl = leaves(port), jax.tree.leaves(ref)
    assert len(pl) == len(rl)
    for a, b in zip(pl, rl):
        b = np.asarray(b)
        assert str(a.dtype).endswith(str(b.dtype)), (a.dtype, b.dtype)
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _jax_state(seed=0):
    """The reference's train state: bf16 params, fp32 moments (nonzero),
    count 5."""
    jm = jbuild(jget_smoke(ARCH))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda d: jnp.asarray(rng.normal(size=d.shape).astype(
            ml_dtypes.bfloat16)), jm.param_defs(), is_leaf=JL.is_def)
    opt = JO.AdamW(JTrainConfig()).init(params)
    opt = JO.AdamWState(
        jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape),
                                           jnp.float32), params),
        jax.tree.map(lambda p: jnp.asarray(rng.random(size=p.shape),
                                           jnp.float32), params),
        jnp.int32(5))
    return {"params": params, "opt": opt}


def _port_like():
    params = build_model(get_smoke(ARCH)).init(0, device=CPU)
    return {"params": params, "opt": TO.AdamW(TrainConfig()).init(params)}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    state = _jax_state()
    JCM(str(tmp_path)).save(state, 7, block=True)
    restored, step = CheckpointManager(str(tmp_path)).restore_latest(
        like=_port_like(), device=CPU)
    assert step == 7
    assert restored["params"]["emb"].dtype == torch.bfloat16
    assert restored["opt"].count.dtype == torch.int32
    assert int(restored["opt"].count) == 5
    _assert_same(restored, state)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port's state, bf16 params and fp32 moments moved off their
    init values, saved asynchronously; the reference restores it."""
    like = _port_like()
    gen = torch.Generator().manual_seed(1)
    state = tree_map(lambda t: t + torch.randn(
        t.shape, generator=gen).to(t.dtype) if t.dim() else t + 9, like)
    cm = CheckpointManager(str(tmp_path))
    cm.save(state, 3)
    cm.wait()
    names = sorted(os.listdir(tmp_path / "step-3"))
    assert names == sorted(["index.json"] + [f"leaf_{i}.npy" for i in
                                             range(len(leaves(state)))])
    with open(tmp_path / "step-3" / "index.json") as f:
        index = json.load(f)
    assert index["step"] == 3
    assert {e["dtype"] for e in index["leaves"]} == {"bfloat16", "float32",
                                                     "int32"}
    jstate = _jax_state()
    restored, step = JCM(str(tmp_path)).restore_latest(like=jstate)
    assert step == 3 and int(restored["opt"].count) == 9
    _assert_same(state, restored)


def test_restore_onto_other_dtypes_and_checks(tmp_path):
    """`like` sets each leaf's dtype; a tree of another size, and
    shardings for another number of leaves, are refused (re-sharding
    itself is held in tests/test_torch_distributed.py)."""
    cm = CheckpointManager(str(tmp_path))
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "n": torch.tensor(2, dtype=torch.int32)}
    cm.save(state, 1, block=True)
    out = cm.restore(1, like={"w": torch.zeros(2, 3, dtype=torch.bfloat16),
                              "n": torch.tensor(0, dtype=torch.int32)},
                     device=CPU)
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].float(), state["w"])
    with pytest.raises(ValueError):
        cm.restore(1, like={"w": state["w"]}, device=CPU)
    with pytest.raises(ValueError):
        cm.restore(1, device=CPU)
    with pytest.raises(ValueError, match="shardings"):
        cm.restore(1, like=state, device=CPU, shardings={"w": None})


@pytest.mark.parametrize("keep,want", [(1, [5]), (3, [3, 4, 5]),
                                       (0, [1, 2, 3, 4, 5])])
def test_keep_garbage_collection(tmp_path, keep, want):
    """Asynchronous saves; the last `keep` commits stay (0 keeps all)."""
    cm = CheckpointManager(str(tmp_path), keep=keep)
    for step in range(1, 6):
        cm.save({"x": torch.full((4,), float(step))}, step)
    cm.wait()
    assert cm.all_steps() == want
    out, step = cm.restore_latest(like={"x": torch.zeros(4)}, device=CPU)
    assert step == 5 and torch.equal(out["x"], torch.full((4,), 5.0))


def test_leftover_tmp_is_never_listed(tmp_path):
    """A write cut before its commit leaves tmp-<step> (or a step
    directory without its index): never listed, never restored; the next
    save of that step replaces it."""
    cm = CheckpointManager(str(tmp_path))
    cm.save({"x": torch.ones(3)}, 2, block=True)
    os.makedirs(tmp_path / "tmp-4")
    np.save(tmp_path / "tmp-4" / "leaf_0.npy", np.zeros(3, np.float32))
    os.makedirs(tmp_path / "step-6")
    assert cm.all_steps() == [2]
    out, step = cm.restore_latest(like={"x": torch.zeros(3)}, device=CPU)
    assert step == 2 and torch.equal(out["x"], torch.ones(3))
    assert JCM(str(tmp_path)).all_steps() == [2]
    cm.save({"x": torch.full((3,), 4.0)}, 4, block=True)
    assert cm.all_steps() == [2, 4]
    assert not os.path.exists(tmp_path / "tmp-4")


def test_save_copies_before_the_background_write(tmp_path):
    """The trainer updates params in place right after a save: the
    checkpoint holds the values at the save."""
    cm = CheckpointManager(str(tmp_path))
    x = torch.zeros(1 << 16)
    cm.save({"x": x}, 1)
    x.add_(1.0)
    cm.wait()
    out = cm.restore(1, like={"x": x}, device=CPU)
    assert float(out["x"].abs().max()) == 0.0
