"""Decode past the tail buffer: the port's transformer.decode_step
against the reference's at tail positions 127 (the last slot), 128 and
131 (past it, where the reference's dynamic_update_slice clamps the
write onto slot 127 and kv_len = tail_pos + 1 attends every slot), on
converted fp32 smoke weights; and a port-only serving request whose
prompt and 130 new tokens run past the buffer.

Tolerance: fp32 weights on both sides run the same algorithm up to fp32
summation order, as in tests/test_torch_models.py (bound 1e-5; measured
differences there 3.6e-7). Tail slots that no step writes stay equal bit
for bit.

  PYTHONPATH=src python -m pytest -q tests/test_torch_decode_positions.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import SparKVConfig, get_smoke  # noqa: E402
from repro_torch.convert import convert_params  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving.engine import SparKVServer  # noqa: E402

ARCH = dict(layers=3, d_model=64, heads=4, d_ff=128, vocab=256)
B, S, ATOL = 2, 32, 1e-5


@pytest.fixture(scope="module")
def models():
    jcfg = jget_smoke("sparkv-qwen3-4b", **ARCH)
    jm = jbuild(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(0)))
    tm = build_model(get_smoke("sparkv-qwen3-4b", **ARCH))
    tp = convert_params(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, S + 1))
    _, ctx = jm.prefill(jp, {"tokens": jnp.asarray(tokens[:, :S],
                                                   jnp.int32)})
    cache = {k: np.asarray(v, np.float32)
             for k, v in JT.init_cache(jcfg, B, S, dtype=jnp.float32).items()}
    cache["k"], cache["v"] = (np.asarray(ctx[n], np.float32)
                              for n in ("k", "v"))
    # the tail as earlier decode steps left it: every slot written
    for n in ("tail_k", "tail_v"):
        cache[n] = rng.normal(size=cache[n].shape).astype(np.float32)
    return jm, jp, tm, tp, tokens, cache


@pytest.mark.parametrize("tail_pos", [127, 128, 131])
def test_decode_past_the_tail_matches_reference(models, tail_pos):
    jm, jp, tm, tp, tokens, cache = models
    assert cache["tail_k"].shape[2] == TT.DECODE_TAIL == 128
    pos = S + tail_pos
    jlg, jnew = jax.jit(jm.decode_step)(
        jp, {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(tokens[:, S], jnp.int32), jnp.int32(pos))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tlg, tnew = tm.decode_step(tp, tcache, torch.from_numpy(tokens[:, S]),
                               pos)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=ATOL,
                               rtol=0, err_msg="logits")
    slot = min(tail_pos, TT.DECODE_TAIL - 1)
    for n in ("tail_k", "tail_v"):
        ref, out = np.asarray(jnew[n]), tnew[n].numpy()
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0, err_msg=n)
        keep = np.arange(TT.DECODE_TAIL) != slot
        assert np.array_equal(out[:, :, keep], cache[n][:, :, keep])
        assert not np.array_equal(out[:, :, slot], cache[n][:, :, slot])


def test_negative_tail_position_stays_refused(models):
    """A position inside the context (tail_pos < 0), which no entry point
    of either package reaches, raises; the reference clamps it onto slot
    0 with an empty mask."""
    _, _, tm, tp, tokens, cache = models
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    with pytest.raises(ValueError, match="before the tail buffer"):
        tm.decode_step(tp, tcache, torch.from_numpy(tokens[:, S]), S - 1)


def test_serving_runs_past_the_tail_buffer():
    """A prompt of 3 and 130 new tokens (133 tail positions, 5 past the
    128 slots), on the port alone, on the CPU: the request completes with
    130 tokens, against the exact cache, which runs past the tail the same
    way, in full agreement."""
    cfg = get_smoke("sparkv-qwen3-4b", **ARCH)
    model = build_model(cfg)
    srv = SparKVServer(model, model.init(0, device="cpu"),
                       SparKVConfig(chunk_tokens=32, q_block=16,
                                    kv_block=16, quant_group=32),
                       chunk_tokens=32, device="cpu")
    rng = np.random.default_rng(0)
    cid = srv.register_context(rng.integers(0, cfg.vocab_size, size=(1, 64)))
    res = srv.generate(cid, rng.integers(0, cfg.vocab_size, size=3),
                       max_new=130, policy="local_prefill", seed=1)
    assert len(res.tokens) == 130 and res.n_streamed == 0
    assert res.top1_agreement == 1.0
