"""The port's dense transformer against the JAX model, on converted
weights: prefill logits and KV, and decode_step logits over a few steps,
for every dense arch (rmsnorm and layernorm, swiglu, geglu and gelu,
qkv biases, tied and untied unembedding)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import convert_params  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCH = dict(layers=3, d_model=64, heads=4, d_ff=128, vocab=256)
B, S, STEPS = 2, 32, 4
DENSE = ["sparkv-qwen3-4b"] + [a for a in ASSIGNED_ARCHS
                               if jget_config(a).family == "dense"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=DENSE)
def models(request):
    jcfg = jget_smoke(request.param, **ARCH)
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_smoke(request.param, **ARCH))
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, size=(B, S + STEPS)).astype(np.int32)
    return jm, jparams, tm, tokens


def _run_jax(jm, params, tokens, dtype=jnp.bfloat16):
    logits, cache = jm.prefill(params, {"tokens": jnp.asarray(tokens[:, :S])})
    full = JT.init_cache(jm.cfg, B, S, dtype=dtype)
    full["k"], full["v"] = cache["k"], cache["v"]
    step = jax.jit(jm.decode_step)
    dec = []
    for i in range(STEPS):
        lg, full = step(params, full, jnp.asarray(tokens[:, S + i]),
                        jnp.int32(S + i))
        dec.append(np.asarray(lg, np.float32))
    return (np.asarray(logits, np.float32), np.asarray(cache["k"], np.float32),
            np.asarray(cache["v"], np.float32), dec)


def _run_torch(tm, params, tokens, dtype=torch.bfloat16):
    tok = torch.from_numpy(tokens).long()
    logits, cache = tm.prefill(params, {"tokens": tok[:, :S]})
    full = TT.init_cache(tm.cfg, B, S, device="cpu", dtype=dtype)
    full["k"], full["v"] = cache["k"], cache["v"]
    dec = []
    for i in range(STEPS):
        lg, full = tm.decode_step(params, full, tok[:, S + i], S + i)
        dec.append(lg.float().numpy())
    return (logits.float().numpy(), cache["k"].float().numpy(),
            cache["v"].float().numpy(), dec)


def _compare(j, t, atol):
    names = ("prefill logits", "prefill k", "prefill v")
    for name, a, b in zip(names, j[:3], t[:3]):
        np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg=name)
    for i, (a, b) in enumerate(zip(j[3], t[3])):
        np.testing.assert_allclose(b, a, atol=atol, rtol=0,
                                   err_msg=f"decode step {i}")


def test_fp32_matches_jax(models):
    """Both param trees cast to fp32: the same algorithm up to fp32
    summation order (XLA and torch reduce in different orders). Measured
    max difference 3.6e-7 on logits of magnitude ~1.3; the bound is
    1e-5."""
    jm, jparams, tm, tokens = models
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    tp32 = convert_params(_np_tree(jp32), device="cpu")
    _compare(_run_jax(jm, jp32, tokens, jnp.float32),
             _run_torch(tm, tp32, tokens, torch.float32), atol=1e-5)


def test_bf16_matches_jax(models):
    """bf16 params as initialised: XLA fuses bf16 elementwise chains
    (norm, gated MLP) and rounds once where torch rounds after each op,
    so values differ by bf16 ulps. Measured max difference on
    sparkv-qwen3-4b 3.9e-3 (one bf16 ulp of a KV value in [0.5, 1)); logits and KV reach ~1.5, whose
    ulp is 7.8e-3, so the bound is two such ulps, 1.6e-2."""
    jm, jparams, tm, tokens = models
    tparams = convert_params(_np_tree(jparams), device="cpu")
    assert tparams["emb"].dtype == torch.bfloat16
    _compare(_run_jax(jm, jparams, tokens), _run_torch(tm, tparams, tokens),
             atol=1.6e-2)


def test_decode_matches_prefill(models):
    """tests/test_models.py's bound on the port alone: one decode step
    after a prefill of S tokens equals the last logits of a prefill of
    S + 1 tokens within 0.15."""
    jm, jparams, tm, tokens = models
    params = convert_params(_np_tree(jparams), device="cpu")
    tok = torch.from_numpy(tokens).long()
    _, cache = tm.prefill(params, {"tokens": tok[:, :S]})
    full = tm.init_cache(B, S, device="cpu")
    full["k"], full["v"] = cache["k"], cache["v"]
    logits, _ = tm.decode_step(params, full, tok[:, S], S)
    ref, _ = tm.prefill(params, {"tokens": tok[:, :S + 1]})
    diff = float((logits.float() - ref.float()).abs().max())
    assert diff < 0.15, f"decode/prefill mismatch {diff}"


def test_model_init_on_cpu_and_families():
    """Model.init draws on the device it is given; every family builds,
    enc-dec included."""
    cfg = get_smoke("sparkv-qwen3-4b", **ARCH)
    params = build_model(cfg).init(0, device="cpu")
    assert params["blocks"]["attn"]["wq"].shape == (3, 64, 4, 16)
    assert params["emb"].dtype == torch.bfloat16
    assert float(params["final_norm"]["scale"].abs().sum()) == 0.0
    build_model(get_smoke("qwen3-moe-235b-a22b"))
    whisper = build_model(get_smoke("whisper-tiny")).init(0, device="cpu")
    assert whisper["pos_emb"].shape == (16, 64)
