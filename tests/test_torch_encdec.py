"""The port's enc-dec family (Whisper) against the JAX model, on
converted fp32 weights: encode, the cross-attention K/V, the
teacher-forced decoder, the loss, prefill and 8 decode steps; the port's
own decode against its teacher-forced decoder; the decode-cache
contract and the position bound.

Tolerances: with both param trees in fp32 the port runs the reference's
algorithm, and outputs differ only by fp32 summation order (XLA and
torch reduce matmuls in different orders). Measured max differences are
under 1e-6 on activations and logits of magnitude ~1; the bounds are
1e-5 (activations, K/V, logits) and 2e-5 (the loss of ~6.2). The bf16
decode-vs-teacher-forced bound is tests/test_models.py's 0.15."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import convert_params  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

B, S_ENC, STEPS = 2, 40, 8
# a cross-attention kv chunk of 16 over 40 encoder states: three chunks,
# the last padded and masked, as whisper-tiny's 1500 states in chunks of
# 1024 are
CHUNK = 16
ATOL, LOSS_ATOL = 1e-5, 2e-5


def _cfgs():
    return (dataclasses.replace(jget_smoke("whisper-tiny"),
                                attn_chunk=CHUNK),
            dataclasses.replace(get_smoke("whisper-tiny"), attn_chunk=CHUNK))


def _draw(jm, seed):
    """fp32 weights for the reference's param defs, drawn with numpy:
    normal leaves N(0, 1) * scale, the zeros/ones leaves (norm scales and
    biases, qkv biases) moved by N(0, 0.1^2) so that they are tested."""
    rng = np.random.default_rng(seed)

    def one(d):
        w = rng.normal(size=d.shape) * (d.scale if d.init == "normal"
                                        else 0.1)
        return (w + (d.init == "ones")).astype(np.float32)
    return jax.tree.map(one, jm.param_defs(), is_leaf=JL.is_def)


def _close(port, ref, atol=ATOL, what=""):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=0, err_msg=what)


@pytest.fixture(scope="module")
def run():
    """Both packages on the smoke config, fp32 weights: the reference's
    outputs of every function under test."""
    jcfg, tcfg = _cfgs()
    jm = jbuild(jcfg)
    w = _draw(jm, 0)
    jp = jax.tree.map(jnp.asarray, w)
    rng = np.random.default_rng(3)
    frames = (rng.normal(size=(B, S_ENC, jcfg.d_model)) * 0.5
              ).astype(np.float32)
    dec = rng.integers(0, jcfg.vocab_size,
                       size=(B, jcfg.dec_len + 1)).astype(np.int32)
    out = {"jcfg": jcfg, "tcfg": tcfg, "tm": build_model(tcfg),
           "tp": convert_params(w, device="cpu"), "frames": frames,
           "dec": dec}
    jf = jnp.asarray(frames)
    enc = JE.encode(jcfg, jp, jf)
    out["j_enc"] = np.asarray(enc)
    out["j_cross"] = [np.asarray(a) for a in JE._cross_kv(jcfg, jp, enc)]
    xs = JE.decode_train(jcfg, jp, enc, jnp.asarray(dec[:, :-1]))
    out["j_dec"] = np.asarray(xs)
    out["j_dec_logits"] = np.asarray(JT.unembed(jcfg, jp, xs))
    out["j_loss"] = float(jm.loss(jp, {"frames": jf,
                                       "dec_tokens": jnp.asarray(dec)}))
    pf = jm.prefill(jp, {"frames": jf})
    out["j_prefill"] = {k: np.asarray(v) for k, v in pf.items()}
    cache = dict(JE.init_cache(jcfg, B, S_ENC, dtype=jnp.float32), **pf)
    step = jax.jit(jm.decode_step)
    logits = []
    for i in range(STEPS):
        lg, cache = step(jp, cache, jnp.asarray(dec[:, i]), jnp.int32(i))
        logits.append(np.asarray(lg))
    out["j_decode"] = logits
    out["j_cache"] = {k: np.asarray(v) for k, v in cache.items()}
    other = (dec[:, STEPS] + 1) % jcfg.vocab_size
    lg, _ = step(jp, cache, jnp.asarray(other), jnp.int32(STEPS))
    out["j_other"] = np.asarray(lg), other
    # past the self-attention cache, where the reference's slices clamp
    out["j_past"] = {}
    for pos in (jcfg.dec_len, jcfg.dec_len + 5):
        lg, new = step(jp, cache, jnp.asarray(dec[:, STEPS]), jnp.int32(pos))
        out["j_past"][pos] = (np.asarray(lg), np.asarray(new["self_k"]),
                              np.asarray(new["self_v"]))
    return out


def test_encode_and_cross_kv(run):
    cfg, tp = run["tcfg"], run["tp"]
    enc = TE.encode(cfg, tp, torch.from_numpy(run["frames"]))
    _close(enc, run["j_enc"], what="encoder output")
    ck, cv = TE._cross_kv(cfg, tp, enc)
    assert ck.shape == (cfg.dec_layers, B, S_ENC, cfg.num_kv_heads,
                        cfg.resolved_head_dim)
    _close(ck, run["j_cross"][0], what="cross k")
    _close(cv, run["j_cross"][1], what="cross v")


def test_decode_train_and_loss(run):
    cfg, tp, dec = run["tcfg"], run["tp"], run["dec"]
    frames = torch.from_numpy(run["frames"])
    enc = TE.encode(cfg, tp, frames)
    x = TE.decode_train(cfg, tp, enc, torch.from_numpy(dec[:, :-1]))
    _close(x, run["j_dec"], what="decoder output")
    loss = run["tm"].loss(tp, {"frames": frames,
                               "dec_tokens": torch.from_numpy(dec)})
    assert abs(float(loss) - run["j_loss"]) < LOSS_ATOL


def test_prefill_and_decode_steps(run):
    cfg, tm, tp, dec = run["tcfg"], run["tm"], run["tp"], run["dec"]
    pf = tm.prefill(tp, {"frames": torch.from_numpy(run["frames"])})
    assert sorted(pf) == ["cross_k", "cross_v"]
    for k in pf:
        _close(pf[k], run["j_prefill"][k], what=f"prefill {k}")
    cache = dict(tm.init_cache(B, S_ENC, device="cpu"), **pf)
    cache = dict(cache, self_k=cache["self_k"].float(),
                 self_v=cache["self_v"].float())
    for i in range(STEPS):
        lg, cache = tm.decode_step(tp, cache, torch.from_numpy(dec[:, i]), i)
        _close(lg, run["j_decode"][i], what=f"decode step {i}")
    for k in cache:
        _close(cache[k], run["j_cache"][k], what=f"cache {k}")


def test_two_decodes_from_one_cache(run):
    """decode_step leaves its input cache as it was: a second decode from
    the same cache (another token, the same position) gives the
    reference's answer, and the cache still holds STEPS tokens."""
    tm, tp, dec = run["tm"], run["tp"], run["dec"]
    cache = {k: torch.from_numpy(v.copy())
             for k, v in run["j_cache"].items()}
    before = {k: v.clone() for k, v in cache.items()}
    tm.decode_step(tp, cache, torch.from_numpy(dec[:, STEPS]), STEPS)
    ref, other = run["j_other"]
    lg, new = tm.decode_step(tp, cache, torch.from_numpy(other), STEPS)
    _close(lg, ref, what="second decode from one cache")
    for k in cache:
        assert torch.equal(cache[k], before[k]), k
    assert not torch.equal(new["self_k"], cache["self_k"])


def test_decode_position_bound(run):
    """Past the self-attention cache (dec_len and dec_len + 5) the port
    answers as the reference, whose slices clamp: the last learned
    position, the new K/V in the last slot, every slot attended (logits
    and self caches within ATOL). A negative position, which no entry
    point of either package reaches, stays refused."""
    cfg, tm, tp = run["tcfg"], run["tm"], run["tp"]
    tok = torch.from_numpy(run["dec"][:, STEPS])
    for pos, (ref, ref_k, ref_v) in run["j_past"].items():
        cache = {k: torch.from_numpy(v.copy())
                 for k, v in run["j_cache"].items()}
        lg, new = tm.decode_step(tp, cache, tok, pos)
        _close(lg, ref, what=f"logits at {pos}")
        _close(new["self_k"], ref_k, what=f"self_k at {pos}")
        _close(new["self_v"], ref_v, what=f"self_v at {pos}")
        assert not torch.equal(new["self_k"][:, :, -1],
                               cache["self_k"][:, :, -1])
    with pytest.raises(ValueError):
        tm.decode_step(tp, tm.init_cache(B, S_ENC, device="cpu"), tok, -1)


def test_decode_matches_teacher_forced_bf16():
    """The port's own check, in its bf16 init: each decode step's logits
    against the teacher-forced decoder's at the same position, within
    tests/test_models.py's decode-vs-prefill bound (0.15)."""
    _, cfg = _cfgs()
    tm = build_model(cfg)
    params = tm.init(0, device="cpu")
    rng = np.random.default_rng(5)
    frames = torch.from_numpy(rng.normal(size=(B, S_ENC, cfg.d_model))
                              .astype(np.float32)).to(torch.bfloat16)
    dec = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        size=(B, cfg.dec_len)))
    enc = TE.encode(cfg, params, frames)
    ref = TT.unembed(cfg, params, TE.decode_train(cfg, params, enc, dec))
    cache = dict(tm.init_cache(B, S_ENC, device="cpu"),
                 **tm.prefill(params, {"frames": frames}))
    worst = 0.0
    for i in range(cfg.dec_len):
        lg, cache = tm.decode_step(params, cache, dec[:, i], i)
        worst = max(worst, float((lg.float() - ref[:, i].float())
                                 .abs().max()))
    assert worst < 0.15, f"decode/teacher-forced mismatch {worst}"
