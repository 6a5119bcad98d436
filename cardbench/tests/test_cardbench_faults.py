"""A run without the look for a card, on the CPU at a tiny size, judged by
a real cell's limits: a sound run is correct; the control (the reference
in the program's place in float8 and at 4 bits) and each fault planted
underneath the timed path are not.

Faults a served cell can have: a decode step that leaves its state (the
KV tail) unchanged; a token altered where it is produced (served and fed
on); an answer altered after it is produced (served, not fed on); a
streamed chunk's values altered where they are dequantized. (A batch of
one request has no half to leave out, and one card no exchange.) Each
fault a cell can have is planted in a run of its family (dense or MoE)
judged by that cell's limits."""
import time

import pytest
import torch

from cardbench import check, harness
from cardbench.tests import tiny


def _run(c, seed=2 ** 31 + 77, seconds=0.5):
    run = harness.Run(c, seed, "cpu", time.perf_counter())
    run.setup()
    run.window(seconds, False)
    return run


def _correct(run, **kw):
    ok, rows = check.verdict(check.judge(run, **kw), run.c.limits)
    return ok and run.failed() == 0, rows


# a run of each family, judged by the limits of its cell
FAMILIES = [(False, "qwen3-4b-l1.hotpotqa-stream"),
            (True, "granite-moe-3b-l2.govreport-decode"),
            (False, "qwen3-4b-l1.govreport-decode")]


@pytest.fixture(scope="module")
def sound():
    return _run(tiny.cell())


def test_sound_run_is_correct(sound):
    ok, rows = _correct(sound)
    assert ok, rows
    assert sound.requests and all(r.n_streamed for r in sound.requests)
    assert set(rows) == {"kv_prefill_err", "kv_stream_err", "logit_err",
                         "kv_decode_err", "kv_first_layer_err", "token_gap"}


def test_control_is_not_correct(sound):
    ok, rows = _correct(sound, control=True)
    assert not ok, rows
    assert rows["kv_stream_err"]["value"] > rows["kv_stream_err"]["limit"]


@pytest.mark.parametrize("moe, limits_of", FAMILIES)
def test_step_that_leaves_its_state_unchanged(monkeypatch, moe, limits_of):
    from repro_torch.models import transformer
    step = transformer.decode_step

    def unchanged(cfg, params, cache, token, pos):
        tails = {k: cache[k].clone() for k in ("tail_k", "tail_v")}
        logits, out = step(cfg, params, cache, token, pos)
        out.update(tails)
        return logits, out
    monkeypatch.setattr(transformer, "decode_step", unchanged)
    ok, rows = _correct(_run(tiny.cell(moe=moe, limits_of=limits_of),
                             seed=5))
    assert not ok and rows["kv_decode_err"]["value"] > rows[
        "kv_decode_err"]["limit"], rows


@pytest.mark.parametrize("moe, limits_of", FAMILIES)
def test_token_altered_where_it_is_produced(monkeypatch, moe, limits_of):
    """At one step a token other than the greedy one wins the logits: the
    program serves it and feeds it on. Only the token gap sees it: the
    logits are compared by their median, and the KV follows the token
    fed."""
    from repro_torch.models import transformer
    step = transformer.decode_step

    def altered(cfg, params, cache, token, pos):
        logits, out = step(cfg, params, cache, token, pos)
        if pos == 64 + 8:
            logits = logits.clone()
            logits[:, (logits[:, :cfg.vocab_size].argmax() + 1)
                   % cfg.vocab_size] = 1e4
        return logits, out
    monkeypatch.setattr(transformer, "decode_step", altered)
    ok, rows = _correct(_run(tiny.cell(moe=moe, limits_of=limits_of),
                             seed=9))
    assert not ok and rows["token_gap"]["value"] > rows["token_gap"][
        "limit"], rows


@pytest.mark.parametrize("moe, limits_of", FAMILIES)
def test_answer_altered_after_it_is_produced(monkeypatch, moe, limits_of):
    """The served answer carries another token than the one the program
    fed on: the first layer's KV of the served tokens gives it away."""
    from repro_torch.serving.engine import SparKVServer
    decode = SparKVServer._decode

    def altered(self, st, cache, prompt, max_new):
        toks, logits = decode(self, st, cache, prompt, max_new)
        toks = toks.copy()
        toks[1] = (toks[1] + 1) % self.model.cfg.vocab_size
        return toks, logits
    monkeypatch.setattr(SparKVServer, "_decode", altered)
    ok, rows = _correct(_run(tiny.cell(moe=moe, limits_of=limits_of),
                             seed=6))
    assert not ok and rows["kv_first_layer_err"]["value"] > rows[
        "kv_first_layer_err"]["limit"], rows


def test_dequantized_chunk_altered(monkeypatch):
    from repro_torch.serving import engine
    into = engine.dequantize_into

    def altered(qts, dests, *, mixed):
        into(qts, dests, mixed=mixed)
        with torch.no_grad():
            dests[0].view(-1)[:8] += torch.as_tensor(
                qts[0].scales[0], dtype=dests[0].dtype)
    monkeypatch.setattr(engine, "dequantize_into", altered)
    ok, rows = _correct(_run(tiny.cell(), seed=7))
    assert not ok and rows["kv_stream_err"]["value"] > rows[
        "kv_stream_err"]["limit"], rows


def test_decode_cell_of_the_moe_family_runs_and_reads():
    c = tiny.cell("local_prefill", moe=True, max_new=20,
                  limits_of="granite-moe-3b-l2.govreport-decode")
    run = _run(c, seed=8)
    numbers = check.judge(run)
    assert set(numbers) == {"kv_prefill_err", "logit_err", "kv_decode_err",
                            "kv_first_layer_err", "token_gap"}
    ok, rows = check.verdict(numbers, c.limits)
    assert ok, rows
    assert all(r.n_streamed == 0 for r in run.requests)
    m = run.metrics(False)
    assert {"ttft_ms", "tpot_ms", "requests_per_s", "setup_s"} <= set(m)
