"""The port's spans (``repro_torch.spans``) and the server's use of them:
the sink and its nesting, the server's phases and the spans inside a
request, nothing recorded outside a server, and profiler ranges only while
a profiler records."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch import spans  # noqa: E402
from repro_torch.configs import SparKVConfig, get_smoke  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import SparKVServer  # noqa: E402
from repro_torch.spans import span  # noqa: E402

ARCH = dict(layers=2, d_model=64, heads=4, d_ff=128, vocab=256)
SP = dict(chunk_tokens=32, q_block=16, kv_block=16, quant_group=32)
PHASES = ("prefill", "quantize", "mask", "huffman_encode", "plan",
          "huffman_decode", "dequant", "decode")
INSIDE = ("generate", "huffman_decode.entropy", "decode.step",
          "decode.step.attention", "decode.step.ffn", "decode.readback")
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(scope="module", params=["sparkv-qwen3-4b",
                                        "granite-moe-3b-a800m"])
def server(request):
    """A tiny server of the dense or the MoE family with one registered
    context of two chunks."""
    cfg = get_smoke(request.param, **ARCH)
    model = build_model(cfg)
    srv = SparKVServer(model, model.init(0, device="cpu"),
                       SparKVConfig(**SP), chunk_tokens=32, device="cpu")
    rng = np.random.default_rng(0)
    cid = srv.register_context(rng.integers(0, cfg.vocab_size,
                                            size=(1, 64)))
    return srv, cid


def _serve(srv, cid):
    """One request that streams every chunk (cachegen); returns its
    ServeResult and the spans it added to ``phase_s``."""
    before = dict(srv.phase_s)
    prompt = np.random.default_rng(1).integers(0, 256, size=3)
    res = srv.generate(cid, prompt, max_new=4, policy="cachegen",
                       compare_exact=False, seed=1)
    return res, {k: v - before.get(k, 0.0) for k, v in srv.phase_s.items()}


class Counting:
    """Stands in for ``torch.profiler.record_function``: keeps each name
    it is built with and enters the real range."""

    def __init__(self, real):
        self.real, self.calls = real, []

    def __call__(self, name, args=None):
        self.calls.append(name)
        return self.real(name, args)


# ------------------------------------------------------------ recorder
def test_span_adds_to_the_innermost_sink():
    outer, inner = {}, {}
    with span("a", into=outer):
        with span("b"):
            pass
        with span("c", into=inner):
            with span("d"):
                pass
        with span("b"):
            pass
    assert set(outer) == {"a", "b"} and set(inner) == {"c", "d"}
    assert outer["a"] >= outer["b"] > 0 and inner["c"] >= inner["d"] > 0
    assert spans._sinks == []


def test_span_outside_a_sink_does_nothing():
    s = span("x", sync=torch.device("cpu"))
    with s:
        pass
    assert s._sink is None and spans._sinks == []


def test_span_pops_its_sink_when_the_block_raises():
    sink = {}
    with pytest.raises(RuntimeError):
        with span("a", into=sink, sync=torch.device("cpu")):
            with span("b"):
                raise RuntimeError("boom")
    assert set(sink) == {"a", "b"} and spans._sinks == []


# -------------------------------------------------------------- server
def test_phase_s_keeps_the_phases_and_gains_the_request_spans(server):
    srv, cid = server
    res, _ = _serve(srv, cid)
    assert res.n_streamed >= 1
    assert set(srv.phase_s) == set(PHASES) | set(INSIDE)


def test_each_child_is_at_most_its_parent(server):
    srv, cid = server
    _, d = _serve(srv, cid)
    assert all(d[k] > 0 for k in PHASES[4:] + INSIDE)
    assert d["huffman_decode.entropy"] <= d["huffman_decode"]
    assert d["decode.step.attention"] + d["decode.step.ffn"] \
        <= d["decode.step"] <= d["decode"]
    assert d["decode.readback"] <= d["decode"]
    assert d["plan"] + d["huffman_decode"] + d["dequant"] + d["decode"] \
        <= d["generate"]


def test_model_decode_step_outside_a_server_records_nothing(server):
    srv, cid = server
    before = dict(srv.phase_s)
    cache = srv.model.init_cache(1, 64, device="cpu")
    rf = Counting(torch.profiler.record_function)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", rf)
        with torch.profiler.profile(activities=CPU):
            srv.model.decode_step(srv.params, cache, torch.tensor([3]), 64)
    assert dict(srv.phase_s) == before
    assert rf.calls == [] and spans._sinks == []


@pytest.mark.parametrize("arch", ["sparkv-qwen3-4b", "granite-moe-3b-a800m",
                                  "zamba2-2.7b"])
def test_model_decode_step_spans_its_attention_and_ffn(arch):
    """Inside a sink, the model's own step span holds its attention and
    MLP or MoE spans, in each family that decodes with
    ``transformer.decode_attention``."""
    model = build_model(get_smoke(arch))
    params = model.init(0, device="cpu")
    cache = model.init_cache(1, 32, device="cpu")
    sink = {}
    with span("request", into=sink):
        model.decode_step(params, cache, torch.tensor([3]), 32)
    assert set(sink) == {"request", "decode.step", "decode.step.attention",
                         "decode.step.ffn"}
    assert sink["decode.step.attention"] + sink["decode.step.ffn"] \
        <= sink["decode.step"] <= sink["request"]


def test_no_profiler_range_while_no_profiler_records(server, monkeypatch):
    srv, cid = server
    rf = Counting(torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", rf)
    _serve(srv, cid)
    assert rf.calls == []


def test_profiler_ranges_nest_under_the_request(server):
    srv, cid = server
    with torch.profiler.profile(activities=CPU) as prof:
        res, _ = _serve(srv, cid)
    ranges = [e for e in prof.events() if e.name.startswith(spans.PREFIX)]
    names = [e.name[len(spans.PREFIX):] for e in ranges]
    assert set(names) == set(PHASES[4:]) | set(INSIDE)
    n_layers = srv.model.cfg.num_layers
    steps = 3 + 4
    assert names.count("generate") == 1
    assert names.count("decode.step") == steps
    assert names.count("decode.step.attention") == steps * n_layers
    assert names.count("decode.step.ffn") == steps * n_layers
    assert names.count("huffman_decode.entropy") == res.n_streamed

    def ancestors(e):
        out = []
        while e.cpu_parent is not None:
            e = e.cpu_parent
            if e.name.startswith(spans.PREFIX):
                out.append(e.name[len(spans.PREFIX):])
        return out
    for e, name in zip(ranges, names):
        up = ancestors(e)
        if name != "generate":
            assert "generate" in up, name
        parent = {"huffman_decode.entropy": "huffman_decode",
                  "decode.step": "decode", "decode.readback": "decode",
                  "decode.step.attention": "decode.step",
                  "decode.step.ffn": "decode.step"}.get(name)
        if parent:
            assert parent in up, (name, up)
