"""The Granite-4.0-H family (``repro_torch.models.granite_hybrid``) on the
port's serving path, against its plain reference
(``cardbench/reference/granite_hybrid.py``), at the tiny size of
``tiny_hybrid`` on the CPU: prefill and greedy decode through the cache
against the reference's full forward pass, the stored KV and the restored
Mamba state against the reference's context state, the float8 control
outside the tolerances, the server's requests leaving the stored state as
it was, the state-byte counter, the ``decode.step.ssm`` span and its
reader, a harness run judged by the cell's limits; the configuration file
against the published config it states."""
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cardbench import check, harness, weights
from cardbench.programs import granite_hybrid as program
from cardbench.reference import common as C
from cardbench.reference import granite_hybrid as R
from cardbench.tests import tiny_hybrid
from repro_torch import spans
from repro_torch.configs.base import SparKVConfig
from repro_torch.models import build_model
from repro_torch.serving.engine import SparKVServer

ROOT = Path(__file__).resolve().parents[2]
S, PROMPT, NEW = 64, 5, 11    # context, prompt and answer tokens
MAMBA = 9                      # Mamba layers of the tiny model's 10

# A position's relative logit error, a token's relative K or V error and a
# state's relative error, of the program against the float32 reference.
# The program computes in bfloat16 (a rounding moves a value by up to 2^-9
# of itself) through ten layers and reads 0.0025-0.0068 on these seeds;
# the float8 control (3 bits of mantissa) reads 0.032-0.061. 0.015 leaves
# the program 2.2x room and lies under the control's smallest.
TOL = 0.015


def _rel(a, b, dim=None):
    """||a - b|| / ||b||, over the whole tensors or along `dim`."""
    a, b = a.double(), b.double()
    if dim is None:
        return float((a - b).norm() / b.norm())
    return (a - b).norm(dim=dim) / b.norm(dim=dim)


def _model(seed):
    conf = tiny_hybrid.conf()
    cfg, _ = program.config(conf)
    model = build_model(cfg)
    params = weights.make(model.abstract_params(), cfg.num_layers, seed,
                          "cpu")
    return conf["model"], model, params


@pytest.fixture(scope="module", params=[2 ** 31 + 11, 2 ** 32 + 12])
def served(request):
    """The program's context state, fed tokens, logits and last cache for
    a context, a prompt and a greedy answer; the reference's context
    state and full-pass logits over the same tokens."""
    m, model, params = _model(request.param)
    g = torch.Generator().manual_seed(request.param % 2 ** 31)
    v = m["vocab_size"]
    ctx = torch.randint(0, v, (S,), generator=g)
    prompt = torch.randint(0, v, (PROMPT,), generator=g).tolist()
    _, pre = model.prefill(params, {"tokens": ctx[None]})
    k, vv, rest = model.context_state(pre)
    cache = model.decode_cache({"k": k, "v": vv, **rest})
    fed, logits, nxt = [], [], None
    for i in range(PROMPT + NEW):
        tok = prompt[i] if i < PROMPT else nxt
        lg, cache = model.decode_step(params, cache, torch.tensor([tok]),
                                      S + i)
        fed.append(tok)
        logits.append(lg[0, :v].float())
        nxt = int(lg[0, :v].argmax())
    ref = R.Reference(m, params)
    seq = torch.cat([ctx, torch.tensor(fed)])
    with C.plain_fp32():
        x, _ = ref.run(seq, 0)
        want = ref.logits(x)[S:]
        state = ref.context_kv(ctx)
    return dict(m=m, params=params, seq=seq, k=k, v=vv, rest=rest,
                cache=cache, got=torch.stack(logits), want=want,
                state=state)


def _logit_err(got, want):
    centred = want - want.mean(-1, keepdim=True)
    return (got - want).double().norm(dim=-1) / centred.double().norm(dim=-1)


def test_decode_through_the_cache_follows_the_full_forward_pass(served):
    err = _logit_err(served["got"], served["want"])
    assert err.shape == (PROMPT + NEW,)
    assert float(err.max()) < TOL, err


def test_stored_kv_and_restored_state_follow_the_reference(served):
    k, v, conv, ssm = served["state"]
    assert served["k"].shape[0] == 1 == k.shape[0]   # layer 5 alone
    for got, want in ((served["k"][:, 0], k), (served["v"][:, 0], v)):
        assert float(_rel(got.flatten(2), want.flatten(2), 2).max()) < TOL
    rest = served["rest"]
    assert rest["conv"].shape[0] == rest["state"].shape[0] == MAMBA
    assert rest["state"].dtype == torch.float32
    assert _rel(rest["conv"][:, 0], conv) < TOL
    assert _rel(rest["state"][:, 0], ssm) < TOL


def test_decode_tail_follows_the_reference(served):
    """The K and V the decode steps wrote into the tail, against those the
    reference's decode adds after its context state."""
    ref = R.Reference(served["m"], served["params"])
    with C.plain_fp32():
        _, dk, dv = ref.decode(served["state"], served["seq"][S:])
    n = PROMPT + NEW
    for tail, want in (("tail_k", dk), ("tail_v", dv)):
        got = served["cache"][tail][:, 0, :n]
        assert float(_rel(got.flatten(2), want.flatten(2), 2).max()) < TOL


def test_float8_control_fails_a_tolerance(served):
    low = R.Reference(served["m"], served["params"], low=C.fp8)
    with C.plain_fp32():
        x, _ = low.run(served["seq"], 0)
        got = low.logits(x)[S:]
        k = low.context_kv(served["seq"][:S])[0]
    assert float(_logit_err(got, served["want"]).max()) > TOL
    assert float(_rel(k.flatten(2), served["state"][0].flatten(2),
                      2).max()) > TOL


def test_kv_layers_and_the_planners_view():
    m, model, _ = _model(1)
    assert model.kv_layers() == R.kv_layers(m) == [5]
    plan = model.plan_config()
    assert plan.family == "moe" and plan.num_layers == 1
    assert (plan.d_model, plan.num_kv_heads, plan.resolved_head_dim,
            plan.moe.num_experts) == (64, 2, 16, 8)
    assert plan.name == model.cfg.name


def _server(seed=2 ** 31 + 21):
    m, model, params = _model(seed)
    sp = SparKVConfig(chunk_tokens=32, q_block=16, kv_block=16,
                      quant_group=32)
    srv = SparKVServer(model, params, sp, device="cpu")
    ctx = np.random.default_rng(seed).integers(0, m["vocab_size"],
                                               size=(1, S))
    return srv, srv.register_context(ctx)


@pytest.mark.parametrize("policy", ["sparkv", "local_prefill"])
def test_requests_leave_the_stored_state_and_repeat_bit_for_bit(policy):
    srv, cid = _server()
    st = srv.contexts[cid]
    before = {n: t.clone() for n, t in st.rest.items()}
    kept = (st.exact_k.clone(), st.exact_v.clone())
    logits = []
    decode = srv._decode

    def keep(*a, **kw):
        toks, lg = decode(*a, **kw)
        logits.append(np.stack(lg))
        return toks, lg
    srv._decode = keep
    res = [srv.generate(cid, np.array([1, 2, 3]), max_new=5, policy=policy,
                        compare_exact=False, seed=1) for _ in range(2)]
    assert np.array_equal(logits[0], logits[1])
    assert np.array_equal(res[0].tokens, res[1].tokens)
    assert (res[0].n_streamed > 0) == (policy == "sparkv")
    assert all(torch.equal(before[n], st.rest[n]) for n in before)
    assert torch.equal(kept[0], st.exact_k)
    assert torch.equal(kept[1], st.exact_v)


def test_served_request_counts_the_state_bytes_it_restored():
    srv, cid = _server()
    res = srv.generate(cid, np.array([4, 5]), max_new=2,
                       compare_exact=False)
    # 9 Mamba layers: a conv window of 3 tokens x (128 x channels + 2 x
    # 16 B and C) in bfloat16, a state of 8 heads x 16 x 16 in float32
    assert res.state_bytes == 9 * (3 * 160 * 2 + 8 * 16 * 16 * 4) == 82_368


def test_transformer_request_restores_no_state():
    from cardbench.tests import tiny
    run = harness.Run(tiny.cell("local_prefill", max_new=2), 5, "cpu",
                      time.perf_counter())
    run.setup()
    st = run.srv.contexts[run.cids[0]]
    assert st.rest == {} and st.rest_bytes() == 0
    res = run.srv.generate(run.cids[0], np.array([1, 2]), max_new=2,
                           compare_exact=False)
    assert res.state_bytes == 0


def test_decode_step_spans_each_mamba_mixer():
    srv, cid = _server()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        srv.generate(cid, np.array([1, 2, 3]), max_new=4,
                     compare_exact=False)
    names = [e.name[len(spans.PREFIX):] for e in prof.events()
             if e.name.startswith(spans.PREFIX)]
    steps = names.count("decode.step")
    assert steps == 3 + 4
    assert names.count("decode.step.ssm") == steps * MAMBA
    assert names.count("decode.step.attention") == steps
    assert names.count("decode.step.ffn") == steps * 10
    d = srv.phase_s
    assert d["decode.step.ssm"] + d["decode.step.attention"] \
        + d["decode.step.ffn"] <= d["decode.step"]


def _request(steps, **phase):
    r = harness.Request(i=0, context=0, prompt=np.zeros(3, np.int64),
                        max_new=4)
    r.steps, r.phase = steps, dict(phase)
    return r


def test_decode_ssm_reader():
    read = harness.reader("decode_ssm_host_ms")
    ctx = lambda *rs: harness.Context(
        requests=list(rs), traced=[], window_s=1.0, served_s=1.0,
        setup_s=1.0, trace=None, model={}, sparkv={}, workload={},
        peak=None, step_flops=None)
    key = "decode.step.ssm"
    # (0.3 + 0.6) s over 10 + 20 steps
    assert read(ctx(_request(10, **{key: 0.3}), _request(20, **{key: 0.6}))
                ) == pytest.approx(30.0)
    # a transformer's requests have no such span
    assert read(ctx(_request(10, **{"decode.step": 0.3}))) is None
    assert read(ctx(_request(0, **{key: 0.0}))) is None
    assert read(ctx()) is None


@pytest.fixture(scope="module")
def harness_run():
    run = harness.Run(tiny_hybrid.cell(), 2 ** 31 + 303, "cpu",
                      time.perf_counter())
    run.setup()
    run.window(1.0, True)
    return run


def test_traced_run_reads_the_hybrid_spans(harness_run):
    m = {k: v["value"] for k, v in harness_run.metrics(True).items()}
    assert m["decode_ssm_host_ms"] + m["decode_attention_host_ms"] \
        + m["decode_ffn_host_ms"] <= m["decode_dispatch_ms"]
    assert m["streamed_chunks"] >= 1 and "huffman_entropy_ms" in m


def test_harness_run_is_correct_and_its_control_is_not(harness_run):
    c = harness_run.c
    ok, rows = check.verdict(check.judge(harness_run), c.limits)
    assert ok and harness_run.failed() == 0, rows
    assert any(r.n_streamed for r in harness_run.requests)
    ok, rows = check.verdict(check.judge(harness_run, control=True),
                             c.limits)
    assert not ok, rows


# the published config.json's names for the model block's
PUBLISHED = {"d_model": "hidden_size", "num_heads": "num_attention_heads",
             "num_kv_heads": "num_key_value_heads",
             "d_ff": "intermediate_size",
             "shared_d_ff": "shared_intermediate_size",
             "vocab_size": "vocab_size", "layer_types": "layer_types",
             "num_layers": "num_hidden_layers",
             "num_hidden_layers": "num_hidden_layers",
             "embedding_multiplier": "embedding_multiplier",
             "attention_multiplier": "attention_multiplier",
             "residual_multiplier": "residual_multiplier",
             "logits_scaling": "logits_scaling", "norm_eps": "rms_norm_eps",
             "tie_embeddings": "tie_word_embeddings",
             ("moe", "num_experts"): "num_local_experts",
             ("moe", "experts_per_token"): "num_experts_per_tok",
             ("ssm", "state_dim"): "mamba_d_state",
             ("ssm", "head_dim"): "mamba_d_head",
             ("ssm", "expand"): "mamba_expand",
             ("ssm", "chunk_len"): "mamba_chunk_size",
             ("ssm", "conv_width"): "mamba_d_conv"}


def test_configuration_file_runs_the_published_config_it_states():
    conf = json.loads((ROOT / "cardbench" / "configs"
                       / "granite-4h-small-l10.json").read_text())
    m = conf["model"]
    for ours, theirs in PUBLISHED.items():
        got = m[ours[0]][ours[1]] if isinstance(ours, tuple) else m[ours]
        assert got == conf[theirs], (ours, theirs)
    assert m["head_dim"] == conf["hidden_size"] // conf["num_attention_heads"]
    assert m["ssm"]["expand"] * m["d_model"] \
        == conf["mamba_n_heads"] * conf["mamba_d_head"]
    was, now = conf["reduced"]["layer_types"]
    assert now == was[:len(now)] == conf["layer_types"]
    assert conf["reduced"]["num_hidden_layers"] == [40, len(now)]
    cfg, _ = program.config(conf)
    assert R.kv_layers(m) == [5]
    assert cfg.moe.capacity_factor * cfg.moe.experts_per_token \
        == pytest.approx(cfg.moe.num_experts)


# a Mamba layer: projections 2*4096*(2*8192 + 2*128 + 128) = 137,363,456
# and 2*8192*4096 = 67,108,864, its state 6*8192*128 = 6,291,456; the
# attention layer 2*4096*48*128 + 2*32*128*4096 = 83,886,080 and
# 4*32*128 = 16,384 a key; a layer's FFN: router 2*4096*72 = 589,824, ten
# experts and the shared one 6*4096*(10*768 + 1536) = 226,492,416; the
# unembedding 2*4096*100,352 = 822,083,584
def test_step_flops_against_a_count_by_hand():
    m = json.loads((ROOT / "cardbench" / "configs"
                    / "granite-4h-small-l10.json").read_text())["model"]
    fixed = (9 * (137_363_456 + 67_108_864 + 6_291_456) + 83_886_080
             + 10 * (589_824 + 226_492_416) + 822_083_584)
    assert fixed == 5_073_666_048
    for kv_len in (11_265, 11_264 + 128):
        assert R.step_flops(m, kv_len) == fixed + 16_384 * kv_len


# ------------------------------------- faults under the new cells' limits
# Each fault planted under the timed path of a streamed run, of the
# hybrid's family or of the Granite-3.0 MoE, judged by its new cell's
# limits, makes the run not correct, by the number that sees it.
STREAM_CELLS = {
    "hybrid": lambda: tiny_hybrid.cell(max_new=10),
    "moe": lambda: __import__("cardbench.tests.tiny", fromlist=["tiny"])
    .cell("sparkv", moe=True, max_new=10,
          limits_of="granite-moe-3b-l2.hotpotqa-stream"),
}


def _module(family):
    from repro_torch.models import granite_hybrid, transformer
    return granite_hybrid if family == "hybrid" else transformer


def _judged(c, seed):
    run = harness.Run(c, seed, "cpu", time.perf_counter())
    run.setup()
    run.window(0.5, False)
    ok, rows = check.verdict(check.judge(run), c.limits)
    return ok and run.failed() == 0, rows


@pytest.mark.parametrize("family", sorted(STREAM_CELLS))
def test_sound_stream_run_is_correct(family):
    ok, rows = _judged(STREAM_CELLS[family](), 2 ** 31 + 41)
    assert ok, rows
    assert "kv_stream_err" in rows


@pytest.mark.parametrize("family", sorted(STREAM_CELLS))
def test_step_that_leaves_its_tail_unchanged(monkeypatch, family):
    mod = _module(family)
    step = mod.decode_step

    def unchanged(cfg, params, cache, token, pos):
        tails = {k: cache[k].clone() for k in ("tail_k", "tail_v")}
        logits, out = step(cfg, params, cache, token, pos)
        return logits, dict(out, **tails)
    monkeypatch.setattr(mod, "decode_step", unchanged)
    ok, rows = _judged(STREAM_CELLS[family](), 2 ** 31 + 42)
    assert not ok and rows["kv_decode_err"]["value"] > rows[
        "kv_decode_err"]["limit"], rows


# The seeded weights are 0.02 N(0, 1) whatever a matrix's fan-in, so a
# contraction over the tiny widths gives activations 8x smaller than over
# the published ones (sqrt(4096 / 64) for the Mamba mixer's input
# projections, sqrt(8192 / 128) for its output projection). There the
# Mamba recurrence's share of a mixer's output, and the mixer's of the
# residual stream, are so small that a fault in the Mamba state moves the
# logits and the KV by less than the program's rounding does. Scaling the
# tiny mixer's matrices by 8 gives its activations the published sizes.
MIXER = ("wx", "wz", "wB", "wC", "wdt", "wo")


@pytest.fixture
def full_balance(monkeypatch):
    make = weights.make

    def scaled(abstract, num_layers, seed, device):
        params = make(abstract, num_layers, seed, device)
        for name in MIXER:
            params["mamba"][name].mul_(8.0)
        return params
    monkeypatch.setattr(harness.weights, "make", scaled)


def test_sound_run_at_the_full_balance_is_correct(full_balance):
    ok, rows = _judged(STREAM_CELLS["hybrid"](), 2 ** 31 + 43)
    assert ok, rows


def test_step_that_leaves_the_mamba_state_unchanged(monkeypatch,
                                                    full_balance):
    """Each step reads the context's Mamba state, never its own: the
    logits see it."""
    mod = _module("hybrid")
    step = mod.decode_step

    def stale(cfg, params, cache, token, pos):
        logits, out = step(cfg, params, cache, token, pos)
        return logits, dict(out, conv=cache["conv"], state=cache["state"])
    monkeypatch.setattr(mod, "decode_step", stale)
    ok, rows = _judged(STREAM_CELLS["hybrid"](), 2 ** 31 + 43)
    assert not ok and rows["logit_err"]["value"] > rows[
        "logit_err"]["limit"], rows


def test_mamba_state_not_restored(monkeypatch, full_balance):
    """A request starts its Mamba layers from zero, not from the stored
    state: the seeded model forgets within a few tokens (its A is about
    -1), so the medians do not see it, and the first KV layer's largest
    error, at the prompt's first tokens, does."""
    load = SparKVServer.load_context

    def zeroed(self, *a, **kw):
        cache, res = load(self, *a, **kw)
        return dict(cache, conv=torch.zeros_like(cache["conv"]),
                    state=torch.zeros_like(cache["state"])), res
    monkeypatch.setattr(SparKVServer, "load_context", zeroed)
    ok, rows = _judged(STREAM_CELLS["hybrid"](), 2 ** 31 + 43)
    assert not ok and rows["kv_first_layer_err"]["value"] > rows[
        "kv_first_layer_err"]["limit"], rows


@pytest.mark.parametrize("family", sorted(STREAM_CELLS))
def test_token_altered_where_it_is_produced(monkeypatch, family):
    mod = _module(family)
    step = mod.decode_step

    def altered(cfg, params, cache, token, pos):
        logits, out = step(cfg, params, cache, token, pos)
        if pos == 64 + 8:
            logits = logits.clone()
            logits[:, (logits[:, :cfg.vocab_size].argmax() + 1)
                   % cfg.vocab_size] = 1e4
        return logits, out
    monkeypatch.setattr(mod, "decode_step", altered)
    ok, rows = _judged(STREAM_CELLS[family](), 2 ** 31 + 44)
    assert not ok and rows["token_gap"]["value"] > rows["token_gap"][
        "limit"], rows


@pytest.mark.parametrize("family", sorted(STREAM_CELLS))
def test_answer_altered_after_it_is_produced(monkeypatch, family):
    decode = SparKVServer._decode

    def altered(self, st, cache, prompt, max_new):
        toks, logits = decode(self, st, cache, prompt, max_new)
        toks = toks.copy()
        toks[1] = (toks[1] + 1) % self.model.cfg.vocab_size
        return toks, logits
    monkeypatch.setattr(SparKVServer, "_decode", altered)
    ok, rows = _judged(STREAM_CELLS[family](), 2 ** 31 + 45)
    assert not ok and rows["kv_first_layer_err"]["value"] > rows[
        "kv_first_layer_err"]["limit"], rows


@pytest.mark.parametrize("family", sorted(STREAM_CELLS))
def test_dequantized_chunk_altered(monkeypatch, family):
    from repro_torch.serving import engine
    into = engine.dequantize_into

    def altered(qts, dests, *, mixed):
        into(qts, dests, mixed=mixed)
        with torch.no_grad():
            dests[0].view(-1)[:8] += torch.as_tensor(
                qts[0].scales[0], dtype=dests[0].dtype)
    monkeypatch.setattr(engine, "dequantize_into", altered)
    ok, rows = _judged(STREAM_CELLS[family](), 2 ** 31 + 46)
    assert not ok and rows["kv_stream_err"]["value"] > rows[
        "kv_stream_err"]["limit"], rows
