"""The port's serving loop against the JAX package's: the same stored
context and the same planner outputs give the same KV cache bit for bit;
the reference's serving assertions hold on the port; the CLI runs."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.compression import huffman as JH  # noqa: E402
from repro.configs import SparKVConfig as JSparKVConfig  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.core import baselines as JB  # noqa: E402
from repro.kernels.kv_dequant import ops as JO  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serving.engine import SparKVServer as JServer  # noqa: E402
from repro_torch.compression import huffman as TH  # noqa: E402
from repro_torch.compression.quantize import QuantizedTensor  # noqa: E402
from repro_torch.configs import SparKVConfig, get_smoke  # noqa: E402
from repro_torch.convert import convert_params  # noqa: E402
from repro_torch.core import baselines as TB  # noqa: E402
from repro_torch.core.chunks import Chunk  # noqa: E402
from repro_torch.data.workloads import WorkloadChunks  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import SparKVServer, StoredContext  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCH = dict(layers=3, d_model=64, heads=4, d_ff=128, vocab=256)
SP = dict(chunk_tokens=32, q_block=16, kv_block=16, quant_group=32)


def _copy(obj, cls, **over):
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    kw.update(over)
    return cls(**kw)


def _port_enc(e):
    return _copy(e, TH.EncodedChunk, code=_copy(e.code, TH.HuffmanCode))


def _port_context(st) -> StoredContext:
    """The reference's StoredContext as the port's dataclasses."""
    enc = {Chunk(*c): (_port_enc(ek), _port_enc(ev),
                       _copy(qk, QuantizedTensor), _copy(qv, QuantizedTensor))
           for c, (ek, ev, qk, qv) in st.encoded.items()}
    return StoredContext(tokens=st.tokens,
                         exact_k=torch.from_numpy(st.exact_k.copy()),
                         exact_v=torch.from_numpy(st.exact_v.copy()),
                         encoded=enc, wl=_copy(st.wl, WorkloadChunks),
                         n_chunks=st.n_chunks)


def _reference_fp32(jsrv, st, streamed):
    """The reference's fp32 assembly (serving/engine.py:210-239), before
    its bf16 cast."""
    k, v = st.exact_k.copy(), st.exact_v.copy()
    ct = jsrv.chunk_tokens
    dec = []
    for c in streamed:
        ek, ev, qk, qv = st.encoded[c]
        dec.append((c, dataclasses.replace(qk, codes=JH.decode(ek).astype(
            np.uint8)), dataclasses.replace(qv, codes=JH.decode(ev).astype(
                np.uint8))))
    if len({q.bits for _, a, b in dec for q in (a, b)}) > 1:
        outs = JO.dequantize_chunks_mixed([q for _, a, b in dec
                                           for q in (a, b)],
                                          out_dtype=jnp.float32)
        pairs = zip(outs[0::2], outs[1::2])
    else:
        pairs = ((JO.dequantize_chunk(a, out_dtype=jnp.float32),
                  JO.dequantize_chunk(b, out_dtype=jnp.float32))
                 for _, a, b in dec)
    for (c, _, _), (kd, vd) in zip(dec, pairs):
        k[c.l, 0, c.t * ct:(c.t + 1) * ct] = np.asarray(kd)
        v[c.l, 0, c.t * ct:(c.t + 1) * ct] = np.asarray(vd)
    return k, v


class FrozenPlanner:
    """Planner stub shared by both packages: its costs come from the
    port's CPU predictor as numpy arrays, so a last-ulp difference between
    XLA and torch matmuls cannot flip a greedy choice."""

    def __init__(self, predictor):
        self.p = predictor
        self.t_dense = predictor.t_dense

    def t_comp_batch(self, *args):
        return np.array(self.p.t_comp_batch(*args))


@pytest.fixture(scope="module")
def servers():
    jcfg = jget_smoke("sparkv-qwen3-4b", **ARCH)
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = convert_params(jax.tree.map(np.asarray, jparams), device="cpu")
    tm = build_model(get_smoke("sparkv-qwen3-4b", **ARCH))
    out = {}
    for sched in ("uniform", "attention"):
        jsrv = JServer(jm, jparams, JSparKVConfig(**SP, alloc_schedule=sched),
                       chunk_tokens=32)
        ctx = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                                size=(1, 96))
        cid = jsrv.register_context(ctx)
        tsrv = SparKVServer(tm, tparams, SparKVConfig(**SP,
                                                      alloc_schedule=sched),
                            chunk_tokens=32, device="cpu")
        tsrv.contexts[cid] = _port_context(jsrv.contexts[cid])
        out[sched] = (jsrv, tsrv, cid)
    return out


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint16)


@pytest.mark.parametrize("sched,policy", [
    ("uniform", p) for p in sorted(TB.PIPELINES)] + [
    ("attention", "cachegen"), ("attention", "sparkv")])
def test_load_context_bit_identical(servers, sched, policy, monkeypatch):
    jsrv, tsrv, cid = servers[sched]
    streamed = _check_load_bit_identical(jsrv, tsrv, cid, policy,
                                         monkeypatch)
    if sched == "attention":
        assert len({q.bits for c in streamed
                    for q in jsrv.contexts[cid].encoded[c][2:]}) > 1


def _check_load_bit_identical(jsrv, tsrv, cid, policy, monkeypatch):
    """Both servers load one stored context with one planner: the same
    plan, and the same fp32 and bf16 caches bit for bit. Returns the
    streamed chunks."""
    key = (tsrv.model.cfg.name, tsrv.profile)
    tsrv._ensure_predictor()
    stub = FrozenPlanner(TB._PRED_CACHE[key])
    monkeypatch.setitem(JB._PRED_CACHE, key, stub)
    monkeypatch.setitem(TB._PRED_CACHE, key, stub)

    jcache, jres = jsrv.load_context(cid, policy=policy, seed=1)
    tcache, tres = tsrv.load_context(cid, policy=policy, seed=1)
    streamed = sorted(jres.engine.streamed_set)
    assert sorted(tres.engine.streamed_set) == streamed
    assert (tres.ttft_s, tres.energy_j) == (jres.ttft_s, jres.energy_j)
    if policy != "local_prefill":
        assert streamed
    jst, tst = jsrv.contexts[cid], tsrv.contexts[cid]
    jk, jv = _reference_fp32(jsrv, jst, streamed)
    tk, tv = tsrv.assemble(tst, streamed)
    assert np.array_equal(tk.numpy().view(np.uint32), jk.view(np.uint32))
    assert np.array_equal(tv.numpy().view(np.uint32), jv.view(np.uint32))
    for name in ("k", "v"):
        assert np.array_equal(_bits(np.asarray(jcache[name])),
                              tcache[name].view(torch.int16).numpy()
                              .view(np.uint16))
    return streamed


@pytest.fixture(scope="module")
def port_server():
    """tests/test_serving.py's fixture on the port, with its own weights
    and its own torch-trained planner."""
    cfg = get_smoke("sparkv-qwen3-4b", **ARCH)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    srv = SparKVServer(model, params, SparKVConfig(**SP), chunk_tokens=32,
                       device="cpu")
    rng = np.random.default_rng(0)
    cid = srv.register_context(rng.integers(0, cfg.vocab_size,
                                            size=(1, 96)))
    return srv, cid, rng


def test_register_context_compresses(port_server):
    srv, cid, _ = port_server
    st = srv.contexts[cid]
    raw = (st.exact_k.numel() + st.exact_v.numel()) * 4
    assert st.wl.total_bytes() < raw / 3       # 5-bit + entropy < fp32/3


@pytest.mark.parametrize("policy", ["sparkv", "cachegen", "local_prefill",
                                    "strong_hybrid"])
def test_serve_fidelity(port_server, policy):
    srv, cid, rng = port_server
    prompt = rng.integers(0, 256, size=3)
    res = srv.generate(cid, prompt, max_new=5, policy=policy, seed=1)
    assert res.top1_agreement >= 0.8
    assert res.mean_kl < 0.5
    n = srv.contexts[cid].n_chunks
    assert res.n_streamed + res.n_computed == n
    if policy == "local_prefill":
        assert res.n_streamed == 0 and res.top1_agreement == 1.0


def test_streamed_cache_within_two_steps(port_server):
    srv, cid, _ = port_server
    cache, res = srv.load_context(cid, policy="cachegen")
    st = srv.contexts[cid]
    assert res.engine.n_streamed == st.n_chunks
    err = float((cache["k"].float() - st.exact_k).abs().max())
    scale_bound = max(float(st.exact_k.abs().max()),
                      float(st.exact_v.abs().max())) / 31
    assert err <= scale_bound * 2 + 1e-4
    assert srv.utilization() == 0.0


def test_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "1"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "registered context 0 on cpu" in out.stdout
    for policy in ("sparkv", "strong_hybrid", "cachegen", "local_prefill"):
        assert policy in out.stdout


# ----------------------------------------------------------------------------
# the MoE family through the same server
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_servers():
    """granite-moe-3b-a800m's smoke config (8 experts, top-2, head_dim
    16) in both packages on the same bf16 weights: the reference's server
    registers a context; the port's server holds that stored context
    (cid 0) and registers the same tokens itself (cid 1)."""
    jcfg = jget_smoke("granite-moe-3b-a800m", **ARCH)
    jm = jbuild(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = convert_params(jax.tree.map(np.asarray, jparams), device="cpu")
    tm = build_model(get_smoke("granite-moe-3b-a800m", **ARCH))
    jsrv = JServer(jm, jparams, JSparKVConfig(**SP), chunk_tokens=32)
    ctx = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(1, 96))
    cid = jsrv.register_context(ctx)
    tsrv = SparKVServer(tm, tparams, SparKVConfig(**SP), chunk_tokens=32,
                        device="cpu")
    tsrv.contexts[cid] = _port_context(jsrv.contexts[cid])
    tsrv._next_id = cid + 1
    own = tsrv.register_context(ctx)
    return jsrv, tsrv, cid, own


@pytest.mark.parametrize("policy", ["sparkv", "cachegen", "local_prefill"])
def test_moe_load_context_bit_identical(moe_servers, policy, monkeypatch):
    jsrv, tsrv, cid, _ = moe_servers
    _check_load_bit_identical(jsrv, tsrv, cid, policy, monkeypatch)


def test_moe_registration_matches_reference(moe_servers):
    """The port's own registration of the same tokens on the same bf16
    weights. Layer 0's exact KV (embedding, norm, projections, RoPE) is
    bit-equal to the reference's, and so are its quantized chunks.
    Deeper layers pass through the MoE blocks, where XLA fuses bf16
    elementwise chains and rounds once where torch rounds after each op:
    their KV differ by bf16 ulps (measured 7.8e-3, two ulps of a value in
    [0.5, 1), on values up to 0.74); the bound is test_torch_models.py's
    bf16 bound, 1.6e-2."""
    jsrv, tsrv, cid, own = moe_servers
    jst, tst = jsrv.contexts[cid], tsrv.contexts[own]
    for name in ("exact_k", "exact_v"):
        j, t = getattr(jst, name), getattr(tst, name).numpy()
        assert np.array_equal(t[0].view(np.uint32), j[0].view(np.uint32))
        np.testing.assert_allclose(t, j, atol=1.6e-2, rtol=0)
    for c, (_, _, jqk, jqv) in jst.encoded.items():
        if c.l == 0:
            tqk, tqv = tst.encoded[Chunk(*c)][2:]
            assert np.array_equal(tqk.codes, jqk.codes)
            assert np.array_equal(tqv.codes, jqv.codes)


@pytest.mark.parametrize("policy", ["sparkv", "cachegen", "local_prefill"])
def test_moe_serve(moe_servers, policy):
    """The port serves its own MoE context: every chunk streamed or
    computed, finite logits, and local_prefill decodes exactly what the
    exact cache decodes (deterministic combine)."""
    _, tsrv, _, own = moe_servers
    prompt = np.random.default_rng(1).integers(0, 256, size=4)
    res = tsrv.generate(own, prompt, max_new=8, policy=policy, seed=1)
    assert res.n_streamed + res.n_computed == tsrv.contexts[own].n_chunks
    assert np.isfinite(res.mean_kl)
    if policy == "local_prefill":
        assert res.n_streamed == 0 and res.top1_agreement == 1.0
    else:
        assert res.n_streamed > 0
