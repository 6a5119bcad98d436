"""The port's MoE, SSM (Mamba2) and hybrid (Zamba2) families against the
JAX models, on converted weights: prefill logits and caches, decode steps,
the loss and the MoE router loss, capacity drops, the SSD scan on its
own, and the decode-cache contract.

Tolerances: with both param trees in fp32 the port runs the reference's
algorithm, and outputs differ only by fp32 summation order (XLA and
torch reduce matmuls in different orders; the MoE combine adds a token's
expert outputs in the reference's order, but the expert matmuls
themselves differ in order). Measured max differences: 3.6e-7 on logits
of magnitude ~1, 1.4e-6 on losses of ~6.2, 3e-7 on MoE block outputs.
The bounds are 1e-5 (logits, caches, MoE outputs) and 2e-5 (losses)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import hybrid as JH  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import convert_params  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import hybrid as TH  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b", "mamba2-130m",
         "zamba2-2.7b"]
MOE = ARCHS[:2]
B, S, STEPS = 2, 32, 4
ATOL, LOSS_ATOL = 1e-5, 2e-5


def _draw(jm, seed, *, perturb):
    """Weights for the reference's param defs, drawn with numpy (a
    jax.random draw compiles once per leaf shape, seconds per arch).
    Normal leaves are N(0, 1) * scale, as ``layers.init_params`` draws
    them. With `perturb`, fp32, and the zeros/ones leaves (norm scales,
    biases, dt_bias, A_log, D) also move by N(0, 0.1^2) so that they are
    tested; without it, the reference's init in its dtypes."""
    rng = np.random.default_rng(seed)

    def one(d):
        if d.init == "normal" or perturb:
            w = rng.normal(size=d.shape) * (d.scale if d.init == "normal"
                                            else 0.1)
            w = w + (d.init == "ones")
        else:
            w = np.full(d.shape, float(d.init == "ones"))
        return w.astype(np.float32 if perturb else jnp.dtype(d.dtype))
    return jax.tree.map(one, jm.param_defs(), is_leaf=JL.is_def)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _leaves(tree, prefix=""):
    """(path, array) of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_trees_close(port, ref, atol, what):
    pl, rl = list(_leaves(port)), list(_leaves(ref))
    assert [p for p, _ in pl] == [p for p, _ in rl], what
    for (path, a), (_, b) in zip(pl, rl):
        a = a.float().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(a, b, atol=atol, rtol=0,
                                   err_msg=f"{what} {path}")


def _jax_decode_cache(jm, pre):
    """The reference's decode cache filled from a prefill, all in fp32: a
    bf16 conv window (the caches' default) would round values that
    differ in the last fp32 bit to different bf16 values. The bf16 window
    is held by test_decode_matches_prefill."""
    fam = jm.cfg.family
    if fam == "moe":
        return dict(JT.init_cache(jm.cfg, B, S, dtype=jnp.float32),
                    k=pre["k"], v=pre["v"])
    if fam == "ssm":
        return pre
    return dict(JH.init_cache(jm.cfg, B, S, dtype=jnp.float32),
                ssm=pre["ssm"], attn_k=pre["attn_k"], attn_v=pre["attn_v"])


def _port_decode_cache(tm, pre):
    fam = tm.cfg.family
    if fam == "moe":
        return dict(TT.init_cache(tm.cfg, B, S, device="cpu",
                                  dtype=torch.float32),
                    k=pre["k"], v=pre["v"])
    if fam == "ssm":
        return pre
    return dict(TH.init_cache(tm.cfg, B, S, device="cpu",
                              dtype=torch.float32),
                ssm=pre["ssm"], attn_k=pre["attn_k"], attn_v=pre["attn_v"])


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """Both packages on one arch's smoke config, fp32 weights: prefill of
    S tokens, STEPS decode steps, a second decode from the prefilled
    cache (another token, the same position), the loss and the aux."""
    arch = request.param
    jm = jbuild(jget_smoke(arch))
    w = _draw(jm, 0, perturb=True)
    jp = jax.tree.map(jnp.asarray, w)
    tm = build_model(get_smoke(arch))
    tp = convert_params(w, device="cpu")
    tokens = np.random.default_rng(3).integers(
        0, jm.cfg.vocab_size, size=(B, S + STEPS + 1)).astype(np.int32)
    other = (tokens[:, S] + 1) % jm.cfg.vocab_size

    out = {"arch": arch, "jm": jm, "tm": tm, "tp": tp,
           "tokens": tokens}
    logits, pre = jm.prefill(jp, {"tokens": jnp.asarray(tokens[:, :S])})
    out["j_prefill"] = (np.asarray(logits), _np(pre))
    step = jax.jit(jm.decode_step)
    cache = _jax_decode_cache(jm, pre)
    lg, _ = step(jp, cache, jnp.asarray(other), jnp.int32(S))
    out["j_other"] = np.asarray(lg)
    dec = []
    for i in range(STEPS):
        lg, cache = step(jp, cache, jnp.asarray(tokens[:, S + i]),
                         jnp.int32(S + i))
        dec.append(np.asarray(lg))
    out["j_decode"], out["j_cache"] = dec, _np(cache)
    batch = {"tokens": jnp.asarray(tokens[:, :S + 1])}
    out["j_loss"] = float(jm.loss(jp, batch))
    if arch in MOE:
        out["j_aux"] = float(JT.forward(jm.cfg, jp, batch["tokens"][:, :-1])
                             [2])
    return out


def _port_prefill(run):
    tok = torch.from_numpy(run["tokens"]).long()
    return run["tm"].prefill(run["tp"], {"tokens": tok[:, :S]})


def test_param_tree_matches_jax(run):
    """Same keys, shapes and dtypes as the reference's tree, so JAX
    weights convert unchanged."""
    jtree = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                         run["jm"].abstract_params())
    ttree = run["tm"].init(0, device="cpu")
    tl, jl = list(_leaves(ttree)), list(_leaves(jtree))
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, t), (_, (shape, dtype)) in zip(tl, jl):
        assert tuple(t.shape) == tuple(shape), path
        assert str(t.dtype) == f"torch.{dtype}", path


def test_prefill_matches_jax(run):
    logits, pre = _port_prefill(run)
    jl, jpre = run["j_prefill"]
    np.testing.assert_allclose(logits.numpy(), jl, atol=ATOL, rtol=0)
    _assert_trees_close(pre, jpre, ATOL, "prefill cache")


def test_decode_steps_match_jax(run):
    """STEPS decode steps from the prefilled cache, each step's logits
    and the final cache."""
    tok = torch.from_numpy(run["tokens"]).long()
    _, pre = _port_prefill(run)
    cache = _port_decode_cache(run["tm"], pre)
    for i in range(STEPS):
        logits, cache = run["tm"].decode_step(run["tp"], cache, tok[:, S + i],
                                              S + i)
        np.testing.assert_allclose(logits.numpy(), run["j_decode"][i],
                                   atol=ATOL, rtol=0,
                                   err_msg=f"decode step {i}")
    _assert_trees_close(cache, run["j_cache"], ATOL, "decode cache")


def test_two_decodes_from_one_cache(run):
    """The decode-cache contract: two tokens decoded at one position from
    one prefilled cache each get the reference's logits. SSM and hybrid
    decode return a new cache and leave the input untouched; the MoE
    (transformer) decode writes its tail buffers in place, where the
    second call overwrites the first call's slot."""
    tok = torch.from_numpy(run["tokens"]).long()
    other = torch.from_numpy((run["tokens"][:, S] + 1)
                             % run["tm"].cfg.vocab_size).long()
    _, pre = _port_prefill(run)
    cache = _port_decode_cache(run["tm"], pre)
    before = [t.clone() for _, t in _leaves(cache)]
    first, _ = run["tm"].decode_step(run["tp"], cache, tok[:, S], S)
    second, _ = run["tm"].decode_step(run["tp"], cache, other, S)
    np.testing.assert_allclose(first.numpy(), run["j_decode"][0], atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(second.numpy(), run["j_other"], atol=ATOL,
                               rtol=0)
    if run["tm"].cfg.family != "moe":
        assert all(torch.equal(a, b) for a, (_, b)
                   in zip(before, _leaves(cache)))


def test_loss_matches_jax(run):
    """Mean next-token xent, plus router_aux_coef * aux / layers for MoE;
    the MoE aux on its own too."""
    tok = torch.from_numpy(run["tokens"][:, :S + 1]).long()
    loss = run["tm"].loss(run["tp"], {"tokens": tok})
    assert abs(float(loss) - run["j_loss"]) < LOSS_ATOL
    if run["arch"] in MOE:
        _, _, aux = TT.forward(run["tm"].cfg, run["tp"], tok[:, :-1])
        assert abs(float(aux) - run["j_aux"]) < LOSS_ATOL
        assert float(aux) > 0


def test_decode_matches_prefill(run):
    """tests/test_models.py's bound on the port alone, with the bf16
    weights as initialised: one decode step after a prefill of S tokens
    equals the last logits of a prefill of S + 1 tokens within 0.15."""
    tm = run["tm"]
    params = convert_params(_draw(run["jm"], 1, perturb=False),
                            device="cpu")
    tok = torch.from_numpy(run["tokens"]).long()
    _, pre = tm.prefill(params, {"tokens": tok[:, :S]})
    if tm.cfg.family == "ssm":
        cache = {"conv": pre["conv"].to(torch.bfloat16),
                 "state": pre["state"]}
    else:
        cache = tm.init_cache(B, S, device="cpu")
        if tm.cfg.family == "moe":
            cache["k"], cache["v"] = pre["k"], pre["v"]
        else:
            cache.update(ssm={"conv": pre["ssm"]["conv"].to(torch.bfloat16),
                              "state": pre["ssm"]["state"]},
                         attn_k=pre["attn_k"], attn_v=pre["attn_v"])
    logits, _ = tm.decode_step(params, cache, tok[:, S], S)
    ref, _ = tm.prefill(params, {"tokens": tok[:, :S + 1]})
    diff = float((logits.float() - ref.float()).abs().max())
    assert diff < 0.15, f"decode/prefill mismatch {diff}"


def _moe_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.moe.num_experts, cfg.d_ff
    p = {"router": rng.normal(size=(d, e)) * 0.1,
         "w_up": rng.normal(size=(e, d, f)) * 0.1,
         "w_gate": rng.normal(size=(e, d, f)) * 0.1,
         "w_down": rng.normal(size=(e, f, d)) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return p, rng.normal(size=(B, S, d)).astype(np.float32)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_block_with_capacity_drops(arch, capacity_factor):
    """moe_block_local on the same inputs in both packages. At capacity
    factor 0.5 the cap (8 slots for 64 tokens x top-2 over 8 experts)
    sits under the mean load of 16, so assignments are surely dropped;
    the port must drop the same ones (the stable sort's order)."""
    def cfg_of(get):
        cfg = get(arch)
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    jcfg, tcfg = cfg_of(jget_smoke), cfg_of(get_smoke)
    p, x = _moe_inputs(tcfg, 0)
    jy, jaux = JL.moe_block_local(jcfg, {k: jnp.asarray(v)
                                         for k, v in p.items()},
                                  jnp.asarray(x))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ty, taux = TL.moe_block_local(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    assert abs(float(taux) - float(jaux)) < ATOL
    _, _, gate_idx = TL.moe_gates(tcfg, tp, torch.from_numpy(x).reshape(
        B * S, -1))
    dropped = TL.moe_dropped(tcfg, gate_idx)
    if capacity_factor < 1:
        assert TL.moe_capacity(tcfg, B * S) == 8
        assert dropped > 0
    # a dropped assignment contributes nothing: a token whose every
    # assignment was dropped comes out zero
    assert torch.isfinite(ty).all()


@pytest.mark.parametrize("s,chunk_len,with_init", [(45, 16, False),
                                                   (45, 16, True),
                                                   (7, 16, True)])
def test_ssd_chunked_matches_jax(s, chunk_len, with_init):
    """The SSD scan on its own at lengths that are not a multiple of the
    chunk (padding), with return_state and an initial state."""
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 3, 8, 16
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, size=(b, s, h)).astype(np.float32)
    A = -rng.uniform(0.1, 1.0, size=(h,)).astype(np.float32)
    Bm = rng.normal(size=(b, s, n)).astype(np.float32)
    Cm = rng.normal(size=(b, s, n)).astype(np.float32)
    init = rng.normal(size=(b, h, p, n)).astype(np.float32) \
        if with_init else None
    jy, jst = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                             chunk_len=chunk_len, return_state=True,
                             init_state=None if init is None
                             else jnp.asarray(init))
    ty, tst = TS.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                             chunk_len=chunk_len, return_state=True,
                             init_state=None if init is None
                             else torch.from_numpy(init))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=1e-5)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), atol=ATOL,
                               rtol=1e-5)
    y_only = TS.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                            chunk_len=chunk_len,
                            init_state=None if init is None
                            else torch.from_numpy(init))
    assert torch.equal(y_only, ty)


def test_conv_tail_left_padded_for_short_prefill():
    """A prefill shorter than the conv window keeps its pre-conv inputs,
    left-padded with zeros, as the reference's cache does."""
    arch = "mamba2-130m"
    jm = jbuild(jget_smoke(arch))
    w = _draw(jm, 1, perturb=True)
    jp = jax.tree.map(jnp.asarray, w)
    tm = build_model(get_smoke(arch))
    tp = convert_params(w, device="cpu")
    tokens = np.array([[5, 9]], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    _assert_trees_close(tc, _np(jc), ATOL, "short prefill cache")
    assert not tc["conv"][:, :, 0].any()


def test_every_decoder_family_builds():
    """build_model covers every family: dense, moe, ssm, hybrid and
    enc-dec (Whisper)."""
    fams = {}
    for arch in ["sparkv-qwen3-4b", *ARCHS, "whisper-tiny"]:
        cfg = get_smoke(arch)
        fams[cfg.family] = build_model(cfg)
    assert sorted(fams) == ["dense", "encdec", "hybrid", "moe", "ssm"]
