"""The port's training stack against the JAX package: gradients of every
family's loss from torch.autograd against jax.grad, the bf16 gradient
barrier, the remat policies, one AdamW update, the schedule, clipping,
the step-indexed data, a 5-step loss trajectory through build_train_step,
the int8 all-reduce at world size 1; then the port's own versions of
tests/test_training.py and its training CLI.

Tolerances, each from the dtype and the measured gap:
  - fp32 gradients: XLA and torch sum in different orders; measured
    within 1.4e-7 of leaves whose largest gradient is ~1e-2 to 1 (6e-6
    of the leaf's largest). Bound: 1e-4 of the leaf's largest, floored at
    1e-3, so leaves that are zero in exact arithmetic (a cross-attention
    key bias, ~1e-11 of noise) pass on the floor.
  - The dense and MoE families put ``bf16_grad_barrier`` at the end of
    each block. The reference cannot differentiate them in fp32 (its scan
    refuses the barrier's bf16 cotangent for an fp32 carry), so they are
    held twice: in fp32 with the barrier made the identity in both
    packages (bound as above), and in bf16 with the barrier (measured
    2.4e-2 of the leaf's largest: bf16 rounding of intermediates that XLA
    keeps in fp32; bound 5e-2).
  - AdamW, schedule, clipping: the same fp32 operations in the same
    order; pow and cos may differ in the last ulp, so rtol 1e-6.
  - The 5-step trajectory (fp32): losses within 1e-5 of ~6.2.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.training import compression as JC  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import trainer as JTR  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import TrainConfig, get_smoke  # noqa: E402
from repro_torch.convert import convert_params  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.training import compression as TC  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training.trainer import (  # noqa: E402
    FaultInjector, build_train_step, data_batch, train_loop, value_and_grad)
from repro_torch.tree import leaves, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


def _draw(jm, seed, dtype=np.float32):
    """Weights for the reference's param defs, drawn with numpy: normal
    leaves N(0, 1) * scale, the zeros/ones leaves moved by N(0, 0.1^2)
    so that they are tested."""
    rng = np.random.default_rng(seed)

    def one(d):
        w = rng.normal(size=d.shape) * (d.scale if d.init == "normal"
                                        else 0.1)
        return (w + (d.init == "ones")).astype(dtype)
    return jax.tree.map(one, jm.param_defs(), is_leaf=JL.is_def)


def _batch(cfg, seed=1, b=2, s=32, frames=12):
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"frames": (rng.normal(size=(b, frames, cfg.d_model)) * 0.1
                           ).astype(np.float32),
                "dec_tokens": rng.integers(0, cfg.vocab_size,
                                           size=(b, cfg.dec_len + 1)
                                           ).astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab_size,
                                   size=(b, s + 1)).astype(np.int32)}


def _f32(a):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else a
    return np.asarray(a, np.float32)


def _assert_grads_close(tg, jg, rel, floor=1e-3):
    tl, jl = leaves(tg), jax.tree.leaves(jg)
    assert len(tl) == len(jl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        a, b = _f32(a), _f32(b)
        bound = rel * max(float(np.abs(b).max()), floor)
        err = float(np.abs(a - b).max())
        assert err <= bound, (i, err, bound)


# -------------------------------------------------------------- gradients

GRAD_CASES = [("qwen2.5-3b", "float32"), ("qwen2.5-3b", "bfloat16"),
              ("granite-moe-3b-a800m", "float32"),
              ("granite-moe-3b-a800m", "bfloat16"),
              ("mamba2-130m", "float32"), ("zamba2-2.7b", "float32"),
              ("whisper-tiny", "float32")]


@pytest.mark.parametrize("arch,dtype", GRAD_CASES)
def test_loss_grads_match_jax_grad(arch, dtype, monkeypatch):
    jm = jbuild(jget_smoke(arch))
    cfg = jm.cfg
    barrier = cfg.family in ("dense", "moe")
    if barrier and dtype == "float32":
        monkeypatch.setattr(JL, "bf16_grad_barrier", lambda x: x)
        monkeypatch.setattr(TL, "bf16_grad_barrier", lambda x: x)
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    w = _draw(jm, 0, np_dtype)
    b = _batch(cfg)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jax.tree.map(jnp.asarray, w), jax.tree.map(jnp.asarray, b))
    tm = build_model(get_smoke(arch))
    tl, tg = value_and_grad(tm.loss, convert_params(w, device=CPU),
                            {k: torch.from_numpy(v) for k, v in b.items()})
    assert all(g.dtype == p.dtype for g, p in
               zip(leaves(tg), leaves(convert_params(w, device=CPU))))
    if dtype == "float32":
        assert abs(float(tl) - float(jl)) < 2e-5
        _assert_grads_close(tg, jg, 1e-4)
    else:
        assert abs(float(tl) - float(jl)) < 1e-3
        _assert_grads_close(tg, jg, 5e-2)


def test_bf16_grad_barrier_rounding():
    """Identity forward; the gradient of an fp32 input carries the bf16
    rounding of the cotangent, the value the reference's custom VJP
    returns (in bf16)."""
    j = jax.grad(lambda x: jnp.sum(JL.bf16_grad_barrier(x) / 3))(
        jnp.ones((4,), jnp.float32))
    x = torch.ones(4, requires_grad=True)
    y = TL.bf16_grad_barrier(x)
    assert torch.equal(y, x)
    (y / 3).sum().backward()
    assert x.grad.dtype == torch.float32
    np.testing.assert_array_equal(x.grad.numpy(), _f32(j))
    assert float(x.grad[0]) == float(torch.tensor(1 / 3).bfloat16())
    assert float(x.grad[0]) != float(torch.tensor(1.0) / 3)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-2.7b",
                                  "whisper-tiny"])
def test_remat_policies_give_equal_grads(arch):
    """"none", "full" and "dots" compute the same gradients; "full"
    keeps fewer activations for the backward pass than "none"."""
    base = get_smoke(arch)
    params = build_model(base).init(0, device=CPU)
    params = tree_map(lambda p: p.float() + 0.01 * torch.randn(
        p.shape, generator=torch.Generator().manual_seed(p.numel())),
        params)
    b = {k: torch.from_numpy(v) for k, v in _batch(base).items()}
    out, saved = {}, {}
    for remat in ("none", "full", "dots"):
        tm = build_model(dataclasses.replace(base, remat=remat))
        nbytes = [0]

        def pack(t):
            nbytes[0] += t.numel() * t.element_size()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out[remat] = value_and_grad(tm.loss, params, b)
        saved[remat] = nbytes[0]
    for remat in ("full", "dots"):
        assert float(out[remat][0]) == float(out["none"][0])
        for a, c in zip(leaves(out[remat][1]), leaves(out["none"][1])):
            torch.testing.assert_close(a, c, atol=1e-7, rtol=1e-6)
    assert saved["full"] < saved["none"]


# -------------------------------------------------------------- optimizer


def _tree(rng, dtype):
    shapes = {"emb": (24, 8), "blocks": {"w": (3, 8, 5), "b": (3, 5)},
              "scale": (8,)}

    def draw(s):
        return rng.normal(size=s).astype(np.float32) * 0.5
    return jax.tree.map(lambda s: draw(s).astype(dtype), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("param_dtype,moment_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_adamw_update_matches_reference(param_dtype, moment_dtype,
                                        monkeypatch):
    """One update from a state at count 3 (nonzero moments), the grads'
    norm above the clip; the port slices every leaf (SLICE_VALUES
    lowered) and writes in place."""
    monkeypatch.setattr(TO, "SLICE_VALUES", 16)
    rng = np.random.default_rng(0)
    pd = ml_dtypes.bfloat16 if param_dtype == "bfloat16" else np.float32
    md = ml_dtypes.bfloat16 if moment_dtype == "bfloat16" else np.float32
    p, g = _tree(rng, pd), _tree(rng, pd)
    m = _tree(rng, md)
    v = jax.tree.map(lambda a: np.abs(a.astype(np.float32)).astype(md),
                     _tree(rng, md))
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
              grad_clip=1.0)
    jopt = JO.AdamW(JTrainConfig(**kw), moment_dtype)
    jst = JO.AdamWState(jax.tree.map(jnp.asarray, m),
                        jax.tree.map(jnp.asarray, v), jnp.int32(3))
    jp, jst2, jmet = jopt.update(jax.tree.map(jnp.asarray, g), jst,
                                 jax.tree.map(jnp.asarray, p))
    topt = TO.AdamW(TrainConfig(**kw), moment_dtype)
    tp = convert_params(p, device=CPU)
    tst = TO.AdamWState(convert_params(m, device=CPU),
                        convert_params(v, device=CPU),
                        torch.tensor(3, dtype=torch.int32))
    tp2, tst2, tmet = topt.update(convert_params(g, device=CPU), tst, tp)
    assert tp2 is tp and tst2.m is tst.m       # in place
    assert int(tst2.count) == 4 and tst2.count.dtype == torch.int32
    assert float(jmet["grad_norm"]) > 1.0
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-6)
    for t, j in ((tp2, jp), (tst2.m, jst2.m), (tst2.v, jst2.v)):
        for a, b in zip(leaves(t), jax.tree.leaves(j)):
            assert str(a.dtype).endswith(str(b.dtype))
            np.testing.assert_allclose(_f32(a), _f32(b), rtol=1e-6,
                                       atol=1e-7)


def test_warmup_cosine_matches_reference():
    js = JO.warmup_cosine(1e-3, warmup=10, total=100)
    ts = TO.warmup_cosine(1e-3, warmup=10, total=100)
    for step in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        np.testing.assert_allclose(float(ts(step)),
                                   float(js(jnp.int32(step))), rtol=1e-6,
                                   atol=0)
        assert ts(torch.tensor(step, dtype=torch.int32)).dtype == \
            torch.float32


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(1)
    tree = _tree(rng, ml_dtypes.bfloat16)
    tree["scale"] = tree["scale"].astype(np.float32)
    jt, jn = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                    max_norm)
    tt, tn = TO.clip_by_global_norm(convert_params(tree, device=CPU),
                                    max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(leaves(tt), jax.tree.leaves(jt)):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "whisper-tiny"])
def test_data_batch_bit_equal(arch):
    """The step-indexed batch, value for value and bit for bit (frames
    rounded from float64 to bf16 as jnp.asarray rounds them)."""
    cfg = get_smoke(arch)
    for step in (0, 7):
        tcfg = TrainConfig(seed=3)
        j = JTR.data_batch(jget_smoke(arch), JTrainConfig(seed=3), step, 4,
                           24)
        t = data_batch(cfg, tcfg, step, 4, 24, device=CPU)
        assert sorted(t) == sorted(j)
        for k in j:
            a, b = t[k], np.asarray(j[k])
            if b.dtype == ml_dtypes.bfloat16:
                assert a.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    a.view(torch.int16).numpy().view(np.uint16),
                    b.view(np.uint16))
            else:
                assert a.dtype == torch.int32
                np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "whisper-tiny"])
def test_five_step_trajectory_matches_reference(arch, monkeypatch):
    """Five steps of build_train_step from the same converted fp32
    weights on the same data_batch: the losses and grad norms agree
    (the dense family with the barrier made the identity in both, see
    the module docstring)."""
    monkeypatch.setattr(JL, "bf16_grad_barrier", lambda x: x)
    monkeypatch.setattr(TL, "bf16_grad_barrier", lambda x: x)
    jm = jbuild(jget_smoke(arch))
    kw = dict(learning_rate=3e-3, warmup_steps=2, total_steps=5)
    jstep, jopt = JTR.build_train_step(jm, JTrainConfig(**kw))
    jstep = jax.jit(jstep)
    w = _draw(jm, 2)
    jp = jax.tree.map(jnp.asarray, w)
    jst = jopt.init(jp)
    tm = build_model(get_smoke(arch))
    tstep, topt = build_train_step(tm, TrainConfig(**kw))
    tp = convert_params(w, device=CPU)
    tst = topt.init(tp)
    f32 = arch == "whisper-tiny"
    for step in range(5):
        jb = JTR.data_batch(jm.cfg, JTrainConfig(**kw), step, 2, 16)
        tb = data_batch(tm.cfg, TrainConfig(**kw), step, 2, 16, device=CPU)
        if f32:     # an fp32 model takes fp32 frames (torch einsum does
            jb = dict(jb, frames=jb["frames"].astype(jnp.float32))
            tb = dict(tb, frames=tb["frames"].float())   # not promote)
        jp, jst, jm_ = jstep(jp, jst, jb)
        tp, tst, tm_ = tstep(tp, tst, tb)
        assert abs(float(tm_["loss"]) - float(jm_["loss"])) < 1e-5, step
        np.testing.assert_allclose(float(tm_["grad_norm"]),
                                   float(jm_["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm_["lr"]), float(jm_["lr"]),
                                   rtol=1e-6)


def test_compressed_psum_world_size_one(tmp_path):
    """The int8 error-feedback all-reduce on a one-rank gloo group
    against the reference's shard_map on a one-device mesh: the same
    mean grads and residuals (one rank: the dequantized codes)."""
    import torch.distributed as dist
    from jax.sharding import Mesh, PartitionSpec as P
    rng = np.random.default_rng(4)
    g = {"a": rng.normal(0, 0.01, (64, 32)).astype(np.float32),
         "b": rng.normal(0, 1.0, (7,)).astype(ml_dtypes.bfloat16)}
    e = {"a": rng.normal(0, 1e-4, (64, 32)).astype(np.float32),
         "b": rng.normal(0, 1e-3, (7,)).astype(np.float32)}
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    fn = jax.shard_map(lambda g, e: JC.compressed_psum(g, e, "data"),
                       mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()))
    jg, je = fn(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e))
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        tg, te = TC.compressed_psum(convert_params(g, device=CPU),
                                    convert_params(e, device=CPU))
    finally:
        dist.destroy_process_group()
    for t, j in ((tg, jg), (te, je)):
        for a, b in zip(leaves(t), jax.tree.leaves(j)):
            assert str(a.dtype).endswith(str(b.dtype))
            np.testing.assert_allclose(_f32(a), _f32(b), rtol=1e-6,
                                       atol=1e-9)
    assert float(leaves(TC.init_error_state(tg))[0].abs().sum()) == 0.0


# ------------------------------------ the port's tests/test_training.py


@pytest.fixture(scope="module")
def small_model():
    return build_model(get_smoke("qwen2.5-3b"))


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def test_loss_improves(small_model):
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=30, warmup_steps=3)
    out = train_loop(small_model, tcfg, batch=4, seq=32, steps=30,
                     log_every=1, device=CPU)
    first, last = out["history"][0][1], out["final_loss"]
    assert last < first


def test_fault_restart_bit_exact(small_model, tmp_path):
    tcfg = TrainConfig(total_steps=12, warmup_steps=2, checkpoint_every=4)
    cm1 = CheckpointManager(str(tmp_path / "a"))
    r1 = train_loop(small_model, tcfg, batch=2, seq=32, steps=12,
                    ckpt_manager=cm1, log_every=1, device=CPU)
    cm2 = CheckpointManager(str(tmp_path / "b"))
    fault = FaultInjector(fail_steps=(7,))
    with pytest.raises(RuntimeError):
        train_loop(small_model, tcfg, batch=2, seq=32, steps=12,
                   ckpt_manager=cm2, fault=fault, log_every=1, device=CPU)
    assert cm2.all_steps() == [4]
    r2 = train_loop(small_model, tcfg, batch=2, seq=32, steps=12,
                    ckpt_manager=cm2, fault=fault, log_every=1, device=CPU)
    assert r2["history"][0][0] == 4
    for a, b in zip(leaves({"p": r1["params"], "o": r1["opt"]}),
                    leaves({"p": r2["params"], "o": r2["opt"]})):
        assert torch.equal(a, b)


def test_grad_accum_equivalence(small_model):
    """microbatches=2 must match a single large batch (same grads)."""
    step1, opt1 = build_train_step(small_model, TrainConfig(microbatches=1))
    step2, opt2 = build_train_step(small_model, TrainConfig(microbatches=2))
    params = small_model.init(0, device=CPU)
    batch = data_batch(small_model.cfg, TrainConfig(), 0, 4, 32, device=CPU)
    p1, _, m1 = step1(_clone(params), opt1.init(params), batch)
    p2, _, m2 = step2(_clone(params), opt2.init(params), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 5e-3
    for a, b in zip(leaves(p1), leaves(p2)):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=2e-2)
    assert any(not torch.equal(a, b) for a, b in
               zip(leaves(p1), leaves(params)))


def test_checkpoint_gc_and_atomicity(tmp_path, small_model):
    cm = CheckpointManager(str(tmp_path), keep=2)
    params = small_model.init(0, device=CPU)
    for step in (1, 2, 3, 4):
        cm.save({"params": params}, step, block=True)
    assert cm.all_steps() == [3, 4]
    restored, step = cm.restore_latest(like={"params": params}, device=CPU)
    assert step == 4
    for a, b in zip(leaves(restored["params"]), leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_schedule_shapes():
    sched = TO.warmup_cosine(1e-3, warmup=10, total=100)
    assert float(sched(0)) == 0.0
    assert abs(float(sched(10)) - 1e-3) < 1e-9
    assert float(sched(100)) < 1e-3


def test_int8_grad_compression_accuracy():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(0, 0.01, (256, 128)).astype(np.float32))
    q, scale = TC._quant_int8(g)
    assert q.dtype == torch.int8
    back = TC._dequant_int8(q, scale)
    rel = float((back - g).abs().max() / g.abs().max())
    assert rel < 0.01  # 1/127 quantization grid


def test_optimizer_convergence_quadratic():
    """AdamW minimizes a quadratic (sanity of the from-scratch optimizer)."""
    tcfg = TrainConfig(learning_rate=0.1, warmup_steps=1, total_steps=200,
                       weight_decay=0.0, grad_clip=100.0)
    opt = TO.AdamW(tcfg)
    params = {"w": torch.ones(8) * 5}
    state = opt.init(params)
    target = torch.arange(8, dtype=torch.float32)
    for _ in range(150):
        _, g = value_and_grad(lambda p, _: torch.sum((p["w"] - target) ** 2),
                              params, None)
        params, state, _ = opt.update(g, state, params)
    assert float((params["w"] - target).abs().max()) < 0.3


def test_train_cli_restarts_and_improves(tmp_path):
    """python -m repro_torch.launch.train on the CPU: the supervisor
    restarts after the injected failure, resumes from the last commit and
    the loss improves."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2.5-3b", "--smoke", "--steps", "20", "--batch", "4", "--seq",
         "32", "--lr", "1e-3", "--ckpt-dir", str(tmp_path), "--ckpt-every",
         "5", "--inject-fault", "12", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[supervisor] failure: injected node failure at step 12" \
        in out.stdout
    assert "(1 restarts)" in out.stdout and "(improved)" in out.stdout
    assert CheckpointManager(str(tmp_path)).all_steps()[-1] == 20


def test_train_cli_asks_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError):
        main(["--arch", "qwen2.5-3b", "--smoke", "--steps", "1"])
