#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SparKV (``src/repro_torch``) on one
NVIDIA card and check it.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions,
     and the build of every CUDA kernel (one nvcc per source, in
     parallel);
  2. each kernel against its plain PyTorch version on the card at the
     main path's shapes and at ragged row counts: bit-equal, and timed
     with CUDA events (median of 50 launches, L2 flushed before each);
  3. path A: sparkv-qwen3-4b at full width and depth, random weights from
     a seed; one 2048-token context (1024-token chunks, 72 KV chunks);
     three requests (sparkv, cachegen, local_prefill), 8 new tokens each;
  4. path B: the same width at 4 layers with per-chunk bit-widths
     (alloc_schedule="attention"), one cachegen request, which takes the
     mixed-bitwidth kernel.

The line before the last is a JSON object naming every kernel with its
launches on the paths, its error against the plain version, its time,
the plain version's time and its bound; the last line is
{"ok": true, "device": {...}}. Without a card, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores

KERNELS = {
    "kv_dequant": {
        "route": "cuda", "source": "src/repro_torch/csrc/kv_dequant.cu",
        "replaces": "src/repro/kernels/kv_dequant/kernel.py:78"},
    "kv_dequant_mixed": {
        "route": "cuda", "source": "src/repro_torch/csrc/kv_dequant.cu",
        "replaces": "src/repro/kernels/kv_dequant/kernel.py:46"},
}
SOURCES = sorted({os.path.splitext(os.path.basename(k["source"]))[0]
                  for k in KERNELS.values()})


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


# ----------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------------


def _bits_equal(a, b):
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return torch.equal(a.view(view), b.view(view))


def _dequant_inputs(gen, n, width, group, bits_choices, device):
    import torch
    g = width // group
    choice = torch.tensor(bits_choices, dtype=torch.int32, device=device)
    bits = choice[torch.randint(0, len(bits_choices), (n, 1), generator=gen,
                                device=device)]
    codes = (torch.randint(0, 256, (n, width), generator=gen, device=device,
                           dtype=torch.int32) % (1 << bits)).to(torch.uint8)
    scales = torch.rand((n, g), generator=gen, device=device) * 0.19 + 0.01
    spans = torch.rand((n, g), generator=gen, device=device) * 3.9 + 0.1
    zeros = torch.randn((n, g), generator=gen, device=device)
    return codes, scales, spans, zeros, bits


def time_ms(fn, flush, n=50):
    """Median device time of `fn` over n launches, each with a cold L2 and
    the stream held busy while the host enqueues it."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def kernel_phase(device):
    """Bit-equality and timing of each kernel against its plain version."""
    import torch
    from repro_torch.kernels.kv_dequant import kernel as K

    gen = torch.Generator(device=device).manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    err = {"kv_dequant": 0.0, "kv_dequant_mixed": 0.0}

    def compare(name, out, plain, label):
        torch.cuda.synchronize()
        ok = _bits_equal(out, plain)
        e = float((out.float() - plain.float()).abs().max()) \
            if out.numel() else 0.0
        err[name] = max(err[name], e)
        print(f"  {name:17s} {label:32s} bit-equal={ok} max_abs_err={e}")
        check(ok, f"{name} differs from its plain version at {label}")

    for n, width, group in ((2048, 512, 64), (37, 128, 64), (255, 256, 64),
                            (129, 128, 32), (5, 192, 64)):
        codes, scales, _, zeros, _ = _dequant_inputs(gen, n, width, group,
                                                     [5], device)
        for dt in (torch.float32, torch.bfloat16):
            out = K.kv_dequant(codes, scales, zeros, group=group,
                               out_dtype=dt)
            plain = K.kv_dequant_plain(codes, scales, zeros, group=group,
                                       out_dtype=dt)
            compare("kv_dequant", out, plain,
                    f"{n}x{width} g{group} 5b {str(dt)[6:]}")
    for n, width, group in ((16 * 2048, 512, 64), (53, 256, 64),
                            (7, 128, 32)):
        codes, _, spans, zeros, bits = _dequant_inputs(
            gen, n, width, group, [3, 4, 5, 6, 8], device)
        for dt in (torch.float32, torch.bfloat16):
            out = K.kv_dequant_mixed(codes, spans, zeros, bits, group=group,
                                     out_dtype=dt)
            plain = K.kv_dequant_mixed_plain(codes, spans, zeros, bits,
                                             group=group, out_dtype=dt)
            compare("kv_dequant_mixed", out, plain,
                    f"{n}x{width} g{group} 3-8b {str(dt)[6:]}")

    # timing at the main path's shapes: one 1024x8x128 chunk (2048 rows of
    # 8 groups of 64) per kv_dequant launch; path B's 8 chunks x (K, V) in
    # one kv_dequant_mixed launch; fp32 out, as load_context asks
    rows = {"kv_dequant": 2048, "kv_dequant_mixed": 16 * 2048}
    width, group = 512, 64
    perf = {}
    for name, n in rows.items():
        codes, scales, spans, zeros, bits = _dequant_inputs(
            gen, n, width, group, [5] if name == "kv_dequant"
            else [3, 4, 5, 6, 8], device)
        g = width // group
        if name == "kv_dequant":
            kern = lambda: K.kv_dequant(codes, scales, zeros, group=group,
                                        out_dtype=torch.float32)
            plain = lambda: K.kv_dequant_plain(codes, scales, zeros,
                                               group=group,
                                               out_dtype=torch.float32)
            nbytes = n * width * (1 + 4) + 2 * n * g * 4
            ops = 2 * n * width
        else:
            kern = lambda: K.kv_dequant_mixed(codes, spans, zeros, bits,
                                              group=group,
                                              out_dtype=torch.float32)
            plain = lambda: K.kv_dequant_mixed_plain(
                codes, spans, zeros, bits, group=group,
                out_dtype=torch.float32)
            nbytes = n * width * (1 + 4) + 2 * n * g * 4 + n * 4
            ops = 2 * n * width + n * g
        ms = time_ms(kern, flush)
        plain_ms = time_ms(plain, flush)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOPS * 1e3
        perf[name] = {
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}
        print(f"  {name:17s} {n}x{width} fp32: kernel {ms:.6f} ms, plain "
              f"{plain_ms:.6f} ms, bound {max(t_bytes, t_ops):.6f} ms "
              f"({nbytes} B)")
    return perf


# ----------------------------------------------------------------------------
# phases 3 and 4: the serving path
# ----------------------------------------------------------------------------


def build_server(cfg, spcfg, device, seed):
    import torch
    from repro_torch.models import build_model
    from repro_torch.serving.engine import SparKVServer
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init(gen, device=device)
    srv = SparKVServer(model, params, spcfg, chunk_tokens=spcfg.chunk_tokens,
                       seed=seed, device=device)
    # observe what generate() loads and decodes, without changing it
    seen = {}
    load, decode = srv.load_context, srv._decode

    def load_and_keep(cid, **kw):
        seen["cache"], seen["res"] = load(cid, **kw)
        return seen["cache"], seen["res"]

    def decode_and_check(st, cache, prompt, max_new):
        toks, logits = decode(st, cache, prompt, max_new)
        seen.setdefault("finite", True)
        seen["finite"] &= all(bool(np.isfinite(lf).all()) for lf in logits)
        seen["n_logits"] = seen.get("n_logits", 0) + len(logits)
        return toks, logits

    srv.load_context = load_and_keep
    srv._decode = decode_and_check
    return srv, seen


def serve_path(label, cfg, spcfg, n_tokens, policies, device, *, seed=0,
               max_new=8):
    """Register one context and serve one request per policy; returns the
    kernels' launches during the path, reset just before it."""
    from repro_torch.device import sync
    from repro_torch.kernels.kv_dequant import kernel as K

    rng = np.random.default_rng(seed)
    srv, seen = build_server(cfg, spcfg, device, seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(1, n_tokens))
    print(f"[{label}] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}; context {n_tokens} tokens, "
          f"chunks of {spcfg.chunk_tokens}, alloc "
          f"{spcfg.alloc_schedule}", flush=True)
    K.reset_launches()
    t0 = time.perf_counter()
    cid = srv.register_context(tokens)
    st = srv.contexts[cid]
    print(f"[{label}] register_context: {time.perf_counter() - t0:.3f} s "
          f"({', '.join(f'{k} {v:.3f}' for k, v in srv.phase_s.items())}),"
          f" {st.n_chunks} chunks, {st.wl.total_bytes() / 1e6:.3f} MB "
          "compressed", flush=True)
    ex_k, ex_v = st.exact_k, st.exact_v
    step_bound = max(float(ex_k.abs().max()), float(ex_v.abs().max())) / 31
    for policy in policies:
        before = dict(K.LAUNCHES)
        phases = dict(srv.phase_s)
        seen.clear()
        prompt = rng.integers(0, cfg.vocab_size, size=4)
        res = srv.generate(cid, prompt, max_new=max_new, policy=policy,
                           seed=1)
        sync(device)
        launched = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
        split = {k: srv.phase_s[k] - phases.get(k, 0.0)
                 for k in srv.phase_s if srv.phase_s[k] - phases.get(k, 0.0)}
        print(f"[{label}] {policy:13s} TTFT(sim) {res.ttft_s:.6f} s, top-1 "
              f"{res.top1_agreement}, KL {res.mean_kl:.6f}, streamed "
              f"{res.n_streamed}/computed {res.n_computed}, wall "
              f"{res.wall_s:.3f} s, launches {launched}", flush=True)
        print(f"[{label}] {policy:13s} wall split: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in split.items()), flush=True)
        check(res.n_streamed + res.n_computed == st.n_chunks,
              f"{policy}: streamed + computed != {st.n_chunks}")
        check(seen.get("finite") and seen["n_logits"] == 2 * max_new,
              f"{policy}: non-finite logits")
        check(math.isfinite(res.mean_kl), f"{policy}: KL not finite")
        if policy == "local_prefill":
            check(res.n_streamed == 0 and res.top1_agreement == 1.0,
                  "local_prefill must match the exact cache")
        if policy == "cachegen":
            cache = seen["cache"]
            err = max(float((cache["k"].float() - ex_k).abs().max()),
                      float((cache["v"].float() - ex_v).abs().max()))
            print(f"[{label}] cachegen cache max |err| {err:.6f} "
                  f"(bound {2 * step_bound + 1e-4:.6f})")
            check(err <= 2 * step_bound + 1e-4,
                  "cachegen cache beyond two quantization steps")
        widths = {q.bits for c in seen["res"].engine.streamed_set
                  for q in st.encoded[c][2:]}
        yield policy, res, launched, widths


# ----------------------------------------------------------------------------


def fail(msg, code=1):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main():
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail("src/repro_torch not found beside chip_smoke.py; run it from "
             "a checkout of the repository", 2)
    sys.path.insert(0, SRC)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # phase 1: card, versions, build
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        fail(f"nvidia-smi: {e}")
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, card {torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as ex:
        libs = list(ex.map(_build.build, SOURCES))
    print(f"[build] {len(libs)} libraries in "
          f"{time.perf_counter() - t0:.3f} s: "
          + ", ".join(os.path.relpath(str(p), ROOT) for p in libs),
          flush=True)

    try:
        print("[kernels] against their plain versions on the card")
        perf = kernel_phase(device)

        from repro_torch.configs import SparKVConfig, get_config
        from repro_torch.kernels.kv_dequant import kernel as K
        cfg = get_config("sparkv-qwen3-4b")
        launches = {name: 0 for name in KERNELS}

        # path A: full width and depth, uniform 5-bit chunks
        spcfg = SparKVConfig(chunk_tokens=1024)
        for policy, res, launched, widths in serve_path(
                "path A", cfg, spcfg, 2048,
                ("sparkv", "cachegen", "local_prefill"), device):
            check(launched["kv_dequant"] == 2 * res.n_streamed,
                  f"{policy}: kv_dequant launches {launched} != 2 x "
                  f"{res.n_streamed} streamed chunks")
            for k in launches:
                launches[k] += launched[k]
        check(launches["kv_dequant"] > 0, "path A never launched kv_dequant")
        K.reset_launches()

        # path B: same width, 4 layers, per-chunk widths
        cfg_b = dataclasses.replace(cfg, num_layers=4)
        spcfg_b = SparKVConfig(chunk_tokens=1024,
                               alloc_schedule="attention")
        for policy, res, launched, widths in serve_path(
                "path B", cfg_b, spcfg_b, 2048, ("cachegen",), device):
            print(f"[path B] streamed chunk widths {sorted(widths)}")
            check(len(widths) > 1, "path B streamed only one width")
            check(launched["kv_dequant_mixed"] >= 1,
                  "path B never launched kv_dequant_mixed")
            for k in launches:
                launches[k] += launched[k]
    except SmokeError as e:
        fail(str(e))

    table = [dict(name=name, **KERNELS[name], launches=launches[name],
                  **perf[name]) for name in KERNELS]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
