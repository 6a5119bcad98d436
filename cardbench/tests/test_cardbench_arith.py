"""The yardstick's arithmetic against values worked out by hand."""
import importlib.util
import json
from pathlib import Path

import pytest

from cardbench.reference.transformer import step_flops

HERE = Path(__file__).resolve().parents[1]


def _config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def _reader(metric):
    spec = importlib.util.spec_from_file_location(
        "m", HERE / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# qwen3-4b-l1: attention 2*2560*32*128 + 2*2560*8*128 = 26,214,400 and
# MLP 3*2560*9728 = 74,711,040 a layer, times 2 * 1 layer; attention
# over the keys 4 * 1 * 32 * 128 = 16,384 a key; unembedding 2 * 2560 *
# 151,936. granite-moe-3b-l2: attention 6,291,456, router 1536 * 40 and
# 8 experts of 3 * 1536 * 512: 18,935,808 a layer, times 2 * 2 layers;
# 4 * 2 * 24 * 64 = 12,288 a key; unembedding 2 * 1536 * 49,155.
@pytest.mark.parametrize("name, kv_len, want", [
    ("qwen3-4b-l1", 11_265, 201_850_880 + 16_384 * 11_265 + 777_912_320),
    ("qwen3-4b-l1", 11_264 + 128, 201_850_880 + 16_384 * 11_392
     + 777_912_320),
    ("granite-moe-3b-l2", 13_313, 100_909_056 + 12_288 * 13_313
     + 151_004_160),
])
def test_step_flops(name, kv_len, want):
    assert step_flops(_config(name)["model"], kv_len) == want


def test_step_flops_values():
    assert step_flops(_config("qwen3-4b-l1")["model"], 11_265) \
        == 1_164_328_960
    assert step_flops(_config("granite-moe-3b-l2")["model"], 13_313) \
        == 415_503_360


# a launch of 3 streamed chunks, K and V: 6 entries of 1024 tokens x 8
# kv heads x head_dim values, 1 byte a code read, 4 bytes a float32
# value written, 8 bytes a group of 64, 40 bytes a table row
@pytest.mark.parametrize("head_dim, want", [
    (128, 6 * 1_048_576 * 5 + 8 * 6 * 16_384 + 40 * 6),
    (64, 6 * 524_288 * 5 + 8 * 6 * 8_192 + 40 * 6),
])
def test_kv_dequant_launch_bytes(head_dim, want):
    nbytes = _reader("kv_dequant_roofline").launch_bytes(
        6, 1024 * 8 * head_dim, 64)
    assert nbytes == want
    assert want in (32_243_952, 16_122_096)


class _Ctx:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_roofline_and_idle_readers_on_a_made_up_trace():
    m = _config("qwen3-4b-l1")
    peak = {"hbm_bytes_per_s": 3.35e12, "bf16_flops_per_s": 989e12}
    trace = {"busy_s": 0.25, "window_s": 1.0,
             "kernels": [("void dequant_kernel<float, false>", 1e-5),
                         ("void dequant_kernel<float, false>", 1e-5),
                         ("gemv", 0.2)]}
    traced = [_Ctx(n_streamed=3), _Ctx(n_streamed=3)]
    ctx = _Ctx(trace=trace, peak=peak, model=m["model"],
               sparkv=m["sparkv"], traced=traced)
    share = _reader("kv_dequant_roofline").read(ctx)
    assert share == pytest.approx(100 * 2 * 32_243_952 / 3.35e12 / 2e-5)
    assert _reader("device_idle_share").read(ctx) == pytest.approx(75.0)
    # no trace, or no dequant kernel in it: nothing to read
    assert _reader("kv_dequant_roofline").read(
        _Ctx(trace=None, peak=peak)) is None
    trace["kernels"] = [("gemv", 0.2)]
    assert _reader("kv_dequant_roofline").read(ctx) is None


def test_mfu_readers():
    m = _config("granite-moe-3b-l2")
    peak = {"bf16_flops_per_s": 989e12}
    r = _Ctx(n_prompt=2, max_new=3, ttft_ms=10.0, after_first_ms=4.0)
    ctx = _Ctx(requests=[r], peak=peak, model=m["model"],
               workload={"context_tokens": 2048}, step_flops=step_flops)
    ttft_ops = sum(step_flops(m["model"], 2049 + j) for j in range(3))
    dec_ops = sum(step_flops(m["model"], 2049 + j) for j in range(3, 5))
    assert _reader("mfu.ttft").read(ctx) == pytest.approx(
        100 * ttft_ops / 0.010 / 989e12)
    assert _reader("mfu.decode").read(ctx) == pytest.approx(
        100 * dec_ops / 0.004 / 989e12)
    assert _reader("mfu.ttft").read(_Ctx(requests=[r], peak=None)) is None
