"""The readers of the program's spans inside a request: values from known
spans, step counts and streamed chunks, None where the program has no such
span (as before it had them) or nothing was counted; and a traced run of
the tiny cells on the CPU reads them all, each child within its parent."""
import time

import numpy as np
import pytest

from cardbench import harness
from cardbench.tests import tiny

PER_STEP = {"decode_dispatch_ms": "decode.step",
            "decode_attention_host_ms": "decode.step.attention",
            "decode_ffn_host_ms": "decode.step.ffn"}


def _request(steps, n_streamed, **phase):
    r = harness.Request(i=0, context=0, prompt=np.zeros(3, np.int64),
                        max_new=4)
    r.steps, r.n_streamed, r.phase = steps, n_streamed, dict(phase)
    return r


def _ctx(*requests):
    return harness.Context(requests=list(requests), traced=[], window_s=1.0,
                           served_s=1.0, setup_s=1.0, trace=None, model={},
                           sparkv={}, workload={}, peak=None,
                           step_flops=None)


@pytest.mark.parametrize("metric", sorted(PER_STEP))
def test_per_step_readers(metric):
    read, key = harness.reader(metric), PER_STEP[metric]
    # (0.2 + 0.4) s over 10 + 20 steps
    ctx = _ctx(_request(10, 0, **{key: 0.2}), _request(20, 1, **{key: 0.4}))
    assert read(ctx) == pytest.approx(20.0)
    assert read(_ctx(_request(10, 0, **{key: 0.2}),
                     _request(20, 0, decode=0.5))) is None
    assert read(_ctx(_request(0, 0, **{key: 0.0}))) is None
    assert read(_ctx()) is None


def test_decode_wait_reader():
    read = harness.reader("decode_wait_ms")
    ctx = _ctx(*[_request(5, 0, **{"decode.readback": s})
                 for s in (0.001, 0.003, 0.010)])
    assert read(ctx) == pytest.approx(3.0)
    assert read(_ctx(_request(5, 0, decode=0.1))) is None
    assert read(_ctx()) is None


def test_huffman_entropy_reader():
    read = harness.reader("huffman_entropy_ms")
    key = "huffman_decode.entropy"
    # per chunk: 1000, 500 and 800 ms; the request that streamed nothing
    # is left out
    ctx = _ctx(_request(5, 1, **{key: 1.0}), _request(5, 2, **{key: 1.0}),
               _request(5, 3, **{key: 2.4}), _request(5, 0, **{key: 0.0}))
    assert read(ctx) == pytest.approx(800.0)
    assert read(_ctx(_request(5, 0, **{key: 0.0}))) is None
    assert read(_ctx(_request(5, 1, huffman_decode=1.0))) is None
    assert read(_ctx()) is None


@pytest.mark.parametrize("moe", [False, True])
def test_traced_tiny_run_reads_every_span_metric(moe):
    c = (tiny.cell("local_prefill", moe=True, max_new=8,
                   limits_of="granite-moe-3b-l2.govreport-decode")
         if moe else tiny.cell())
    run = harness.Run(c, 2 ** 31 + 91, "cpu", time.perf_counter())
    run.setup()
    run.window(1.0, True)
    m = {k: v["value"] for k, v in run.metrics(True).items()}
    assert m["decode_attention_host_ms"] + m["decode_ffn_host_ms"] \
        <= m["decode_dispatch_ms"] <= m["decode_step_ms"]
    assert "decode_wait_ms" in m
    assert ("huffman_entropy_ms" in m) is not moe
