"""Each model family owns its cache layout: the decode cache of a prefill
holds exactly ``cache_axes``' leaves, the leaves it adds are
``init_cache``'s in the context's dtype, prefill's own pass through as
they are, and ``prefill_out_axes`` names exactly prefill's outputs. SparKV
serves the families that state ``kv_layers`` and ``plan_config``; the
others are refused."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import (ModelConfig, MoEConfig,  # noqa: E402
                                      SSMConfig)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.granite_hybrid import \
    GraniteHybridConfig  # noqa: E402

B, S = 2, 32
GRANITE_HYBRID = "granite-hybrid-tiny"
# one smoke model a family: dense, moe, hybrid, ssm, encdec, hybrid_moe
ARCHS = ["sparkv-qwen3-4b", "granite-moe-3b-a800m", "zamba2-2.7b",
         "mamba2-130m", "whisper-tiny", GRANITE_HYBRID]
# the leaf whose dtype the decode cache's new leaves take
CONTEXT_K = {"dense": "k", "moe": "k", "hybrid_moe": "k",
             "hybrid": "attn_k", "encdec": "cross_k", "ssm": None}


def _granite_hybrid():
    """Granite-4.0-H at a smoke size: 4 layers, attention at 2."""
    base = ModelConfig(
        name=GRANITE_HYBRID, family="hybrid_moe", num_layers=4, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32, vocab_size=256,
        tie_embeddings=True,
        moe=MoEConfig(num_experts=4, experts_per_token=2,
                      capacity_factor=4.0),
        ssm=SSMConfig(state_dim=16, head_dim=16, chunk_len=16))
    return GraniteHybridConfig(
        base=base, layer_types=("mamba", "mamba", "attention", "mamba"),
        shared_d_ff=48, embedding_multiplier=12.0,
        attention_multiplier=0.0625, residual_multiplier=0.22,
        logits_scaling=16.0)


def _flat(tree, prefix=()):
    """{path: leaf} of nested dicts and tuples (a leaf: a tensor, or a
    tuple of axis names)."""
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items()
                for p, x in _flat(v, prefix + (k,)).items()}
    if isinstance(tree, tuple) and tree and not all(
            a is None or isinstance(a, str) for a in tree):
        return {p: x for i, v in enumerate(tree)
                for p, x in _flat(v, prefix + (i,)).items()}
    return {prefix: tree}


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """A smoke model of the family, its params and a prefill's output."""
    arch = request.param
    cfg = _granite_hybrid() if arch == GRANITE_HYBRID else get_smoke(arch)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    if cfg.family == "encdec":
        inputs = {"frames": torch.randn((B, S, cfg.d_model), generator=gen
                                        ).to(torch.bfloat16)}
    else:
        inputs = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                          generator=gen)}
    with torch.no_grad():
        out = model.prefill(params, inputs)
    pre = out if cfg.family == "encdec" else out[1]
    return {"model": model, "params": params, "out": out, "pre": pre}


def test_decode_cache_holds_exactly_cache_axes_leaves(run):
    model = run["model"]
    dec = model.decode_cache(run["pre"])
    assert set(_flat(dec)) == set(_flat(model.cache_axes()))
    for path, ax in _flat(model.cache_axes()).items():
        assert len(ax) == _flat(dec)[path].ndim, path


def test_decode_cache_adds_init_cache_leaves_in_the_context_dtype(run):
    """The leaves decode writes take init_cache's shapes and the dtype and
    device of the context K (fp32 here, where init_cache's default is
    bf16), and are zero."""
    model = run["model"]
    pre = {n: (t.float() if isinstance(t, torch.Tensor) else t)
           for n, t in run["pre"].items()}
    dec = model.decode_cache(pre)
    init = _flat(model.init_cache(B, S, device="cpu"))
    added = set(_flat(dec)) - set(_flat(pre))
    ref = CONTEXT_K[model.cfg.family]
    assert bool(added) == (ref is not None)
    for path in added:
        t = _flat(dec)[path]
        assert t.shape == init[path].shape, path
        assert t.dtype == pre[ref].dtype == torch.float32, path
        assert t.device == pre[ref].device
        assert not t.any(), path


def test_decode_cache_passes_prefill_leaves_through(run):
    """Prefill's own leaves are the same objects in the decode cache, and
    one decode step runs on it."""
    model, pre = run["model"], run["pre"]
    dec = model.decode_cache(pre)
    for name, leaf in pre.items():
        assert dec[name] is leaf, name
    pos = 0 if model.cfg.family == "encdec" else S
    with torch.no_grad():
        logits, _ = model.decode_step(run["params"], dec,
                                      torch.zeros(B, dtype=torch.long), pos)
    assert logits.shape[0] == B and torch.isfinite(logits.float()).all()


def test_prefill_out_axes_names_exactly_prefill_outputs(run):
    model, out = run["model"], run["out"]
    axes = model.prefill_out_axes()
    got, want = _flat(out), _flat(axes)
    assert set(got) == set(want)
    for path, ax in want.items():
        assert len(ax) == got[path].ndim, path
    if model.cfg.family != "encdec":
        assert axes[0] == ("batch", "act_vocab")


def test_kv_layers_and_plan_config(run):
    """The families SparKV serves: every layer of a transformer, itself
    planned; a hybrid_moe's attention layers, planned as a MoE
    transformer of them. The others raise."""
    model = run["model"]
    cfg = model.cfg
    if cfg.family in ("dense", "moe"):
        assert model.kv_layers() == list(range(cfg.num_layers))
        assert model.plan_config() is cfg
    elif cfg.family == "hybrid_moe":
        assert model.kv_layers() == [2]
        assert model.plan_config() == dataclasses.replace(
            cfg.base, family="moe", num_layers=1)
    else:
        for fn in (model.kv_layers, model.plan_config):
            with pytest.raises(ValueError, match="SparKV serves dense, moe "
                               f"and hybrid_moe models, not {cfg.family}"):
                fn()
