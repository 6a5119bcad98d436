#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SparKV (``src/repro_torch``) on one
NVIDIA card and check it.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions,
     and the build of every CUDA kernel (one nvcc per source, in
     parallel), with ptxas's registers, shared memory and spills of each;
  2. each kernel against its plain PyTorch version on the card at the
     main path's shapes and at ragged row counts: bit-equal, and timed
     with CUDA events (median of 50 launches, L2 flushed before each).
     The dequant kernel also takes staged batches into K and V caches
     (ragged entries, several widths, groups 64, 32, 24 and 8, fp32 and
     bf16; nothing written outside the entries) and whole requests: one
     launch over a cachegen request's 144 chunk tensors and over path B's
     16 (mixed form), timed beside its plain version and, for the uniform
     form, in turns with the one torch.addcmul call that computes the
     same values;
  3. path A: sparkv-qwen3-4b at full width and depth, random weights from
     a seed; one 2048-token context (1024-token chunks, 72 KV chunks);
     two requests (sparkv, local_prefill), 8 new tokens each, the
     streaming one dequantized in exactly one kv_dequant launch and its
     cache within two quantization steps of the exact one;
     then the dequant of every stored chunk timed on the host clock two
     ways in turns: the per-chunk route (a launch per chunk tensor, plus
     a slice copy) and the one staged launch;
  4. path B: the same width at 4 layers with per-chunk bit-widths
     (alloc_schedule="attention"), one cachegen request, which takes the
     mixed form in exactly one launch;
  5. path C: sparse prefill attention at full width: layer 0's q/k/v of
     path A's weights for a seeded 8192-token sequence through
     kernels/block_sparse_attn/ops.sparse_prefill_attention (one
     block-sparse launch), against the plain version on the same block
     lists; then the full causal list against layers.flash_attention;
     then a block-size sweep: sparse_prefill_attention at (q_block,
     kv_block) of (16, 16), (32, 32), (96, 96) and (128, 128) over 1536
     seeded tokens at Qwen3-4B's heads, bf16 and fp32 against the plain
     version (one launch each), bf16 timed beside SDPA with the block mask;
  6. path D: decode attention over path A's sparkv cache, one
     kernels/decode_attn/ops.decode_attention call per layer (36 calls,
     one kernel launch each), each against the plain version and
     layers.flash_attention; then one long cache (32768 positions,
     kv_len 32000) in bf16 and fp32;
  7. path K: both attention kernels at the head shapes (hq, hkv,
     head_dim) of every attention-bearing config, ten in all, at full
     width and b = 1, seeded random q/k/v: sparse_prefill_attention over
     2048 tokens (causal, the serving mass, 128-token blocks) and
     decode_attention at kv_len 2048 and 32,000 in bf16, both at 2048 in
     fp32; each call one launch, held against its plain version on the
     same inputs and lists; bf16 timed beside its bound and SDPA (masked
     for block-sparse, enable_gqa for decode); the path's wall time;
  8. path E1: SparKVServer.serve_fleet on path A's server and context: 32
     jobs, seeded Poisson arrivals, the policies sparkv, strong_hybrid,
     cachegen and local_prefill mixed, a 2-slot WFQ run queue, SLO
     admission with a deadline and 8 decoded tokens a request; then one
     load_context of a streaming policy the fleet admitted (sparkv where
     it did), in exactly one kv_dequant launch;
  9. path E2: a standalone ServingCluster at sparkv-qwen3-4b's width
     with the planner trained on the card: 256 requests of the traffic
     mix of examples/serve_fleet.py on 4 devices and 2 APs, a KV memory
     budget that forces evictions, the cloud KV store, a handoff storm
     with the fleet LP rebalancer and the online predictor refresh on
     the card; run twice, and the two fleet fingerprints must be equal;
 10. path F: granite-moe-3b-a800m (the MoE family) at full width and
     depth through SparKVServer, random bf16 weights from a seed; one
     2048-token context (1024-token chunks, 64 KV chunks of head_dim 64);
     requests sparkv and local_prefill, 8 new tokens each: the streaming
     request in exactly one kv_dequant launch, its assembled fp32 cache
     bit-equal to the plain dequant of the same stored chunks,
     local_prefill top-1 1.0; then the MoE layers' capacity drop rate
     over the context's prefill;
 11. path G: mamba2-130m (SSM) and zamba2-2.7b (hybrid) at full width and
     depth, random bf16 weights from a seed: a 2048-token prefill and 8
     decode steps each, timed with CUDA events; the first step's logits
     against the 2049-token prefill's last logits (printed), and the same
     check on an fp32 copy of the weights at 256 tokens (limit 0.15, as
     tests/test_models.py). Each model is freed before the next is built;
 12. path H: whisper-tiny (enc-dec) at full width and depth, random bf16
     weights: prefill (encode + cross-K/V) of 4 x 1500 frames and 32
     greedy decode steps, CUDA events; 16 teacher-forced decode steps
     against decode_train's logits on an fp32 copy (limit 0.15) and in
     bf16 (printed);
 13. path T1: qwen2.5-3b trained at full width and depth (bf16 params,
     fp32 moments, remat "full"): 6 build_train_step steps on data_batch
     at 2 x 1024 tokens, loss, grad norm, lr and ms a step (CUDA events),
     peak memory, tokens/s and model FLOP/s; loss and grad norm finite,
     params changed; then microbatches=2 against 1 on the first batch
     (loss within 5e-3, params within 2e-2, tests/test_training.py);
 14. path S: the same training through the sharded step: a one-rank
     NCCL process group (a local store, no gloo), make_local_mesh((1, 1))
     and make_rules, qwen2.5-3b at full width and depth through
     jit_train_step (DTensor params and moments) for T1's first 3 steps
     from T1's seed and batches; losses and grad norms within 1e-6 of
     T1's (printed, with the param probes' difference), ms a step and
     peak memory beside T1's; then compressed_psum over one layer's grads
     on NCCL (the mean equals the grads to int8 rounding, the residual
     carries); the group is destroyed before T2;
 15. path T2: whisper-tiny's train_loop at 4 x 1500 frames, 12 steps,
     a checkpoint every 4, uninterrupted and with a failure injected at
     step 7 and a restart from the last commit, under deterministic
     algorithms: the final params and moments bit-equal; the checkpoint
     write and restore seconds;
 16. path P: prefill and decode over DTensors: a one-rank NCCL group, a
     (1, 1) mesh and the dry run's rules (prefill, and weight-stationary
     for decode); sparkv-qwen3-4b, then mamba2-130m, at full width and
     depth, random bf16 weights from a seed: a 2048-token prefill and 8
     decode steps over DTensors beside the plain port on the same
     weights and tokens, every logits tensor and the prefill and final
     caches within 1e-6; ms a prefill and a decode step (CUDA events)
     and ops a call, through DTensor and plain; the group is destroyed;
 17. path R: the dry run in a subprocess: a fake 256-rank process group,
     the 16x16 production mesh typed CUDA over fake tensors, and the
     cells mamba2-130m x decode_32k and granite-moe-3b-a800m x
     decode_32k; each record's status, seconds, peak bytes a rank,
     flops, collectives by kind and roofline terms (the H100 model's
     estimates); the subprocess's exit code decides;
 18. the harness path: the port's benchmark harness in a subprocess,
     python -m benchmarks_torch.run --quick --only fig8,fig4,quality
     --device cuda; its exit code decides, each bench's wall time is
     printed, and every cachegen request of the quality bench must have
     dequantized its streamed chunks in one kv_dequant launch;
 19. path X: the port's examples (examples_torch/) as a user runs them.
     quickstart in this process under repro_torch.device.named("cuda"),
     at its own size: its sparkv and cachegen requests each dequantize in
     exactly one kv_dequant launch, local_prefill in none at fidelity
     1.00. Each in a subprocess whose exit code decides: train_lm at its
     own size (~100M params, 200 steps, a failure injected at step 120,
     the supervisor's restart from the last commit, its own "loss
     improved" assertion; restarts, the step it resumed at, first and
     last loss and ms a step printed), elastic_rescale on a one-rank NCCL
     group and a (1, 1) mesh, and serve_fleet and serve_under_volatility
     through python -m examples_torch.run ... --device cuda (these two,
     host simulations, run beside the others from the path's start).
     Every wall time stands beside the card's name and power limit.

Path E's TTFT, SLO attainment and energy are the fleet simulator's
virtual clock, labelled "(simulated)"; beside them it prints what the
card and host did: the fleet's wall seconds, the planner MLP's calls and
their host-clock seconds (a device synchronise before and after each).

Phase 2 also holds the attention kernels to their plain versions at the
shapes of tests/test_kernels.py in fp32 (atol 2e-5) and bf16 (atol 2e-2,
compared in fp32), each scaled by the reference's largest magnitude where
that is under 1, the bf16 block-sparse kernel also at its tile edges
(q_block and kv_block 64 and 256, lists with empty rows and entries out
of range or past the count) and decode at its stage edges. Paths C and D
time the attention kernels at their shapes beside their plain versions
and the one PyTorch call that computes the same function
(scaled_dot_product_attention, timed only), kernel and library in turns
(kernel, library, library, kernel), and print the achieved rate and
share of the bound.

The line before the last is a JSON object naming every kernel with its
launches on the paths, its error against the plain version, its time,
the plain version's time, the library call's time and its bound; the
last line is {"ok": true, "device": {...}}. Without a card, or outside a
checkout of the repository, it exits non-zero and prints no result.
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
BF16_FLOPS = 989e12              # H100 SXM bf16 tensor cores, dense
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}   # attention, as in
                                             # tests/test_kernels.py

KERNELS = {
    "kv_dequant": {
        "route": "cuda", "source": "src/repro_torch/csrc/kv_dequant.cu",
        "replaces": "src/repro/kernels/kv_dequant/kernel.py:78"},
    "kv_dequant_mixed": {
        "route": "cuda", "source": "src/repro_torch/csrc/kv_dequant.cu",
        "replaces": "src/repro/kernels/kv_dequant/kernel.py:46"},
    "block_sparse_attention": {
        "route": "cuda", "source": "src/repro_torch/csrc/block_sparse_attn.cu",
        "replaces": "src/repro/kernels/block_sparse_attn/kernel.py:82"},
    "decode_attention": {
        "route": "cuda", "source": "src/repro_torch/csrc/decode_attn.cu",
        "replaces": "src/repro/kernels/decode_attn/kernel.py:65"},
}
SOURCES = sorted({os.path.splitext(os.path.basename(k["source"]))[0]
                  for k in KERNELS.values()})


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def ptxas_summary(report):
    """One line per kernel of a ptxas -v report: registers, shared memory
    (static), stack and spills."""
    import re
    lines, name, frame = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            try:
                name = subprocess.run(["c++filt", name], capture_output=True,
                                      text=True, timeout=10).stdout.strip()
            except (OSError, subprocess.SubprocessError):
                pass
            name = re.sub(r"\(anonymous namespace\)::|\(.*", "", name)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = (f"stack {m.group(1)} B, spills {m.group(2)}/"
                     f"{m.group(3)} B")
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            lines.append(f"{name}: {m.group(1)} registers, "
                         f"{smem.group(1) if smem else 0} B static smem, "
                         f"{frame}")
            name, frame = None, ""
    return lines


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
    return statistics.median(time_samples(fn, flush, n))


def time_in_turns(kernel, library, flush, n=50):
    """Median device times of `kernel` and `library`, taken in turns
    (kernel, library, library, kernel), n / 2 launches a turn."""
    a = time_samples(kernel, flush, n // 2)
    b = time_samples(library, flush, n // 2)
    b += time_samples(library, flush, n // 2)
    a += time_samples(kernel, flush, n // 2)
    return statistics.median(a), statistics.median(b)


def time_samples(fn, flush, n):
    """Device times of `fn` over n launches (see time_ms)."""
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
    return times


def _perf(err, ms, plain_ms, library_ms, nbytes, ops, peak):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


# the batches of tests/test_torch_kv_dequant.py: (group, mixed form,
# entries of (cache, slot, values, bits)) into K and V caches of 6 slots of
# 4096 values; ragged counts, several widths, slots left unwritten
BATCHES = [
    (64, False, [("k", 0, 1000, 5), ("v", 0, 1000, 5), ("k", 2, 33, 5),
                 ("v", 3, 64, 5), ("k", 4, 17, 5), ("v", 5, 4096, 5),
                 ("k", 5, 1, 5)]),
    (32, False, [("k", 1, 100, 4), ("v", 1, 4096, 4), ("v", 4, 31, 4)]),
    (64, True, [("k", 0, 1000, 3), ("v", 0, 1000, 8), ("k", 1, 4096, 5),
                ("v", 2, 65, 4), ("k", 3, 7, 6), ("v", 4, 4096, 5)]),
    (32, True, [("k", 0, 48, 4), ("k", 2, 4000, 6), ("v", 2, 4000, 5),
                ("v", 5, 129, 3)]),
    (64, True, [("v", 1, 4096, 5), ("k", 3, 333, 5)]),
    # groups that are not a multiple of 16 (each entry padded to a 16-byte
    # boundary of the flat codes), both forms
    (8, False, [("k", 0, 1000, 5), ("v", 0, 999, 5), ("k", 2, 33, 5),
                ("v", 3, 4096, 5), ("k", 4, 17, 5), ("v", 5, 1, 5)]),
    (24, True, [("k", 0, 48, 4), ("k", 2, 4001, 6), ("v", 2, 4000, 5),
                ("v", 5, 129, 3)]),
    (8, True, [("v", 1, 4096, 5), ("k", 3, 333, 8), ("k", 4, 39, 3)]),
    (24, False, [("k", 1, 100, 4), ("v", 1, 4096, 4), ("v", 4, 31, 4)]),
]
SENTINEL = -7.25


def _qt(rng, n, bits, group, shape):
    """A random chunk tensor of n values at `bits` (codes, spans, steps
    and zeros drawn directly: no quantizer pass over the data)."""
    from repro_torch.compression.quantize import QuantizedTensor
    g = -(-n // group)
    spans = rng.uniform(0.1, 4.0, g).astype(np.float32)
    return QuantizedTensor(
        codes=rng.integers(0, 1 << bits, n, dtype=np.uint8),
        scales=(spans / np.float32((1 << bits) - 1)).astype(np.float32),
        zeros=rng.normal(size=g).astype(np.float32), bits=bits, group=group,
        shape=shape, spans=spans)


def _request_chunks(rng, n_layers, widths, device, *, n_tokens=2048,
                    ct=1024, hkv=8, hd=128, group=64):
    """A streamed request at Qwen3-4B's KV width: the K and V chunk
    tensors of every (layer, 1024-token chunk), and a function that makes
    a fresh pair of fp32 caches and the destination of each chunk in it."""
    import torch
    qts = [_qt(rng, ct * hkv * hd, int(rng.choice(widths)), group,
               (ct, hkv, hd))
           for _ in range(n_layers * (n_tokens // ct) * 2)]

    def caches():
        cache = {c: torch.full((n_layers, 1, n_tokens, hkv, hd), SENTINEL,
                               device=device) for c in "kv"}
        dests = [cache[c][l, 0, t * ct:(t + 1) * ct]
                 for l in range(n_layers) for t in range(n_tokens // ct)
                 for c in "kv"]
        return cache, dests
    return qts, caches


def _batch_bytes(qts, out_bytes=4):
    """What one launch must move: each code read once (1 B), each value
    written once, each group's two parameters and each table row (5
    int64) read once."""
    n = sum(int(np.prod(q.shape)) for q in qts)
    g = sum(q.scales.shape[0] for q in qts)
    return n * (1 + out_bytes) + 8 * g + 40 * len(qts), n, g


def kernel_phase(device):
    """Bit-equality and timing of the dequant kernel against its plain
    version: the row-matrix forms, staged batches into K and V caches,
    and whole requests."""
    import torch
    from repro_torch.kernels.kv_dequant import kernel as K
    from repro_torch.kernels.kv_dequant import ops as KO

    gen = torch.Generator(device=device).manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    err = {"kv_dequant": 0.0, "kv_dequant_mixed": 0.0}

    def compare(name, out, plain, label):
        torch.cuda.synchronize()
        ok = _bits_equal(out, plain)
        e = float((out.float() - plain.float()).abs().max()) \
            if out.numel() else 0.0
        err[name] = max(err[name], e)
        print(f"  {name:17s} {label:36s} bit-equal={ok} max_abs_err={e}")
        check(ok, f"{name} differs from its plain version at {label}")

    # the row-matrix forms (one entry; one entry a row when mixed)
    for n, width, group in ((2048, 512, 64), (37, 128, 64), (255, 256, 64),
                            (129, 128, 32), (5, 192, 64), (64, 128, 8),
                            (33, 96, 24), (20, 120, 40)):
        codes, scales, _, zeros, _ = _dequant_inputs(gen, n, width, group,
                                                     [5], device)
        for dt in (torch.float32, torch.bfloat16):
            out = K.kv_dequant(codes, scales, zeros, group=group,
                               out_dtype=dt)
            plain = K.kv_dequant_plain(codes, scales, zeros, group=group,
                                       out_dtype=dt)
            compare("kv_dequant", out, plain,
                    f"rows {n}x{width} g{group} 5b {str(dt)[6:]}")
    for n, width, group in ((16 * 2048, 512, 64), (53, 256, 64),
                            (7, 128, 32), (64, 128, 8), (33, 96, 24)):
        codes, _, spans, zeros, bits = _dequant_inputs(
            gen, n, width, group, [3, 4, 5, 6, 8], device)
        for dt in (torch.float32, torch.bfloat16):
            out = K.kv_dequant_mixed(codes, spans, zeros, bits, group=group,
                                     out_dtype=dt)
            plain = K.kv_dequant_mixed_plain(codes, spans, zeros, bits,
                                             group=group, out_dtype=dt)
            compare("kv_dequant_mixed", out, plain,
                    f"rows {n}x{width} g{group} 3-8b {str(dt)[6:]}")

    # staged batches into K and V caches: kernel and plain version write
    # the same bits, and the kernel nothing outside its entries
    rng = np.random.default_rng(0)
    for group, mixed, entries in BATCHES:
        qts = [_qt(rng, n, b, group, (n,)) for _, _, n, b in entries]
        name = "kv_dequant_mixed" if mixed else "kv_dequant"
        for dt in (torch.float32, torch.bfloat16):
            out = []
            for run in (K.dequant_batch, K.dequant_batch_plain):
                cache = {c: torch.full((6, 4096), SENTINEL, dtype=dt,
                                       device=device) for c in "kv"}
                run(KO.stage(qts, [cache[c][slot] for c, slot, _, _
                                   in entries], mixed=mixed))
                out.append(torch.cat([cache["k"], cache["v"]]))
            label = (f"batch {len(entries)} entries g{group} "
                     f"{sorted({b for *_, b in entries})}b {str(dt)[6:]}")
            compare(name, out[0], out[1], label)
            written = torch.zeros((12, 4096), dtype=torch.bool,
                                  device=device)
            for c, slot, n, _ in entries:
                written[slot + 6 * (c == "v"), :n] = True
            check(bool((out[0][~written] == SENTINEL).all()),
                  f"{name} wrote outside its entries at {label}")

    # timing, fp32 out as load_context asks: the single-chunk shape of the
    # per-chunk design (one chunk tensor, 2048 x 512 codes), a cachegen
    # request of path A (36 layers x 2 chunks x K/V = 144 entries) and
    # path B's request (4 layers, widths 4/5/6: 16 entries, the mixed
    # form); the uniform form beside the one PyTorch call that computes
    # the same values, in turns
    perf = {}
    for label, name, n_layers, widths in (
            ("one chunk (2048x512)", "kv_dequant", None, [5]),
            ("cachegen request", "kv_dequant", 36, [5]),
            ("path B request", "kv_dequant_mixed", 4, [4, 5, 6])):
        mixed = name == "kv_dequant_mixed"
        if n_layers is None:
            qts = [_qt(rng, 2048 * 512, 5, 64, (1024, 8, 128))]
            caches = lambda: (None, [torch.empty((1024, 8, 128),
                                                 device=device)])
        else:
            qts, caches = _request_chunks(rng, n_layers, widths, device)
        got = []
        for run in (K.dequant_batch, K.dequant_batch_plain):
            cache, dests = caches()
            run(KO.stage(qts, dests, mixed=mixed))
            got.append(torch.cat([d.reshape(-1) for d in dests]))
        compare(name, got[0], got[1], f"{label} fp32")
        del got
        cache, dests = caches()
        b = KO.stage(qts, dests, mixed=mixed)
        kern = lambda: K.dequant_batch(b)
        plain_ms = time_ms(lambda: K.dequant_batch_plain(b), flush)
        n_groups = b.params.numel()
        if mixed:
            ms, lib_ms = time_ms(kern, flush), None
        else:
            ms, lib_ms = time_in_turns(kern, lambda: torch.addcmul(
                b.zeros[:, None], b.codes.view(n_groups, b.group),
                b.params[:, None]), flush)
        nbytes, n_vals, _ = _batch_bytes(qts)
        ops = 2 * n_vals + (n_groups if mixed else 0)
        entry = _perf(err[name], ms, plain_ms, lib_ms, nbytes, ops,
                      FP32_FLOPS)
        grid = K.grid_size(b.codes.numel(), mixed=mixed,
                           out_dtype=torch.float32)
        print(f"  {name:17s} {label}, {len(qts)} entries, grid {grid} CTAs: "
              f"kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
              + (f"torch.addcmul {lib_ms:.6f} ms, " if lib_ms else
                 "library none (a division and an addcmul), ")
              + f"bound {entry['bound_ms']:.6f} ms ({nbytes} B); kernel "
              f"{nbytes / ms / 1e9:.3f} TB/s, {entry['bound_ms'] / ms:.1%} "
              "of its bound", flush=True)
        if n_layers is not None:
            perf[name] = entry
        del b, cache, dests, caches
    return perf


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _tolerance(ref, dtype_name):
    """The attention tolerance, scaled down by the reference's largest
    magnitude where that is under 1: outputs that average many random
    values lie near 0, where the absolute tolerance would be loose."""
    top = float(ref.float().abs().max()) if ref.numel() else 0.0
    return ATOL[dtype_name] * min(1.0, top)


def _compare_close(err, name, out, ref, dtype_name, label):
    """Check |out - ref| against the attention tolerance and record it in
    `err` (the errors against the plain versions)."""
    import torch
    torch.cuda.synchronize()
    e, tol = _max_err(out, ref), _tolerance(ref, dtype_name)
    ok = bool(torch.isfinite(out.float()).all()) and e <= tol
    err[name] = max(err.get(name, 0.0), e)
    print(f"  {name:22s} {label:40s} max_abs_err={e:.3e} "
          f"(atol {tol:.3e}) {'ok' if ok else 'FAILED'}")
    check(ok, f"{name} beyond tolerance at {label}")


def attention_phase(device):
    """The two attention kernels against their plain versions at the
    shapes of tests/test_kernels.py, in fp32 and bf16."""
    import torch
    from repro_torch.kernels.block_sparse_attn import kernel as BK
    from repro_torch.kernels.block_sparse_attn.ops import block_lists
    from repro_torch.kernels.decode_attn import kernel as DK

    gen = torch.Generator(device=device).manual_seed(1)
    err = {}
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    # (kv rows, kv_group, s, d, causal, mass): test_kernels.py:30-35,
    # its GQA cases :51-63, non-causal lists as in :239-253
    for bh_kv, g, sl, d, causal, mass in (
            (4, 1, 512, 64, True, 0.9), (2, 1, 1024, 128, True, 0.9),
            (2, 1, 256, 128, True, 0.9), (6, 1, 384, 64, True, 0.9),
            (2, 2, 256, 64, True, 0.95), (2, 4, 256, 64, True, 0.95),
            (2, 8, 256, 64, True, 0.95), (2, 1, 512, 64, False, 0.85),
            (3, 1, 384, 128, False, 0.98)):
        for dn, dt in dtypes.items():
            q = torch.randn((bh_kv * g, sl, d), generator=gen, device=device)
            k = torch.randn((bh_kv, sl, d), generator=gen, device=device)
            v = torch.randn((bh_kv, sl, d), generator=gen, device=device)
            q, k, v = q.to(dt), k.to(dt), v.to(dt)
            idx, cnt = block_lists(q, k, g, mass=mass, q_block=128,
                                   kv_block=128, causal=causal)
            out = BK.block_sparse_attention(q, k, v, idx, cnt,
                                            causal=causal, kv_group=g)
            plain = BK.block_sparse_attention_plain(q, k, v, idx, cnt,
                                                    causal=causal,
                                                    kv_group=g)
            _compare_close(err, "block_sparse_attention", out, plain, dn,
                           f"{bh_kv * g}x{sl}x{d} g{g} "
                           f"{'causal' if causal else 'full'} m{mass} {dn}")
    # the full causal list (idx = arange, cnt = qb + 1) is dense causal
    # attention (test_kernels.py:66-82)
    for bh_kv, g, sl, d in ((2, 1, 256, 64), (2, 4, 1024, 128)):
        for dn, dt in dtypes.items():
            q = torch.randn((bh_kv * g, sl, d), generator=gen,
                            device=device).to(dt)
            k = torch.randn((bh_kv, sl, d), generator=gen,
                            device=device).to(dt)
            v = torch.randn((bh_kv, sl, d), generator=gen,
                            device=device).to(dt)
            idx, cnt = _full_causal_lists(bh_kv * g, sl // 128, device)
            out = BK.block_sparse_attention(q, k, v, idx, cnt, kv_group=g)
            kr = k.float().repeat_interleave(g, 0)
            vr = v.float().repeat_interleave(g, 0)
            sc = torch.einsum("bqd,bkd->bqk", q.float(), kr) * d ** -0.5
            tril = torch.ones(sl, sl, dtype=torch.bool, device=device).tril()
            dense = torch.einsum("bqk,bkd->bqd",
                                 torch.softmax(sc.masked_fill(~tril,
                                                              -torch.inf),
                                               -1), vr)
            _compare_close({}, "block_sparse_attention", out, dense, dn,
                           f"{bh_kv * g}x{sl}x{d} g{g} full list vs dense "
                           f"{dn}")
    # the bf16 tensor-core kernel at its tile edges: 64 and 128 query rows
    # a CTA, q_block and kv_block 64 and 256, lists with holes
    for bh_kv, g, sl, d, qb, kb in ((2, 1, 512, 64, 64, 64),
                                    (1, 4, 512, 128, 64, 256),
                                    (1, 8, 512, 64, 256, 64),
                                    (2, 4, 512, 128, 256, 256)):
        for causal in (True, False):
            q, k, v = (torch.randn((n, sl, d), generator=gen,
                                   device=device).to(torch.bfloat16)
                       for n in (bh_kv * g, bh_kv, bh_kv))
            idx, cnt, seen, seen_cnt = lists_with_holes(
                gen, bh_kv * g, sl // qb, sl // kb, device)
            out = BK.block_sparse_attention(q, k, v, idx, cnt,
                                            causal=causal, q_block=qb,
                                            kv_block=kb, kv_group=g)
            plain = BK.block_sparse_attention_plain(
                q, k, v, seen, seen_cnt, causal=causal, q_block=qb,
                kv_block=kb, kv_group=g)
            _compare_close(err, "block_sparse_attention", out, plain,
                           "bfloat16", f"{bh_kv * g}x{sl}x{d} g{g} qb{qb} "
                           f"kb{kb} {'causal' if causal else 'full'} holes")
            check(not out[0, :qb].any(),
                  "block_sparse_attention: a row with cnt 0 is not zero")
    # decode: test_kernels.py:85-90, kv_len 0, a ragged kv_len at Qwen3-4B
    # heads, the edges of a 64-key stage (kv_len 1, 63, 65)
    for b, hq, hkv, skv, d, klen, blk in (
            (2, 8, 2, 512, 64, 400, 256), (1, 4, 4, 1024, 128, 1024, 256),
            (3, 16, 2, 768, 128, 700, 128), (2, 8, 1, 512, 256, 333, 512),
            (2, 8, 2, 512, 64, 0, 256), (1, 32, 8, 2048, 128, 1999, 256),
            (1, 32, 8, 300, 128, 300, 256), (3, 16, 2, 1024, 128, 1, 256),
            (3, 16, 2, 1024, 128, 63, 256), (3, 16, 2, 1024, 128, 65, 256)):
        for dn, dt in dtypes.items():
            q = torch.randn((b, hq, d), generator=gen, device=device).to(dt)
            k = torch.randn((b, skv, hkv, d), generator=gen,
                            device=device).to(dt)
            v = torch.randn((b, skv, hkv, d), generator=gen,
                            device=device).to(dt)
            before = DK.LAUNCHES["decode_attention"]
            out = DK.decode_attention(q, k, v, klen, kv_block=blk)
            check(DK.LAUNCHES["decode_attention"] == before + 1,
                  "decode_attention: not one launch a call")
            plain = DK.decode_attention_plain(q, k, v, klen, kv_block=blk)
            _compare_close(err, "decode_attention", out, plain, dn,
                           f"b{b} {hq}/{hkv} skv{skv} d{d} len{klen} "
                           f"blk{blk} {dn}")
            if klen == 0:
                check(not out.any(), "decode_attention: kv_len 0 not zero")
    return err


def lists_with_holes(gen, bh, n_qb, n_kb, device):
    """Random block lists that also hold entries outside [0, n_kb), a row
    with cnt 0 (the first) and a count past the list's end (the last);
    with the lists the kernel walks in them, for the plain version."""
    import torch
    from repro_torch.kernels.block_sparse_attn.kernel import listed_blocks
    nnz = n_kb + 2
    idx = torch.randint(-1, n_kb + 1, (bh, n_qb, nnz), generator=gen,
                        device=device, dtype=torch.int32)
    cnt = torch.randint(0, nnz + 3, (bh, n_qb), generator=gen, device=device,
                        dtype=torch.int32)
    cnt[0, 0] = 0
    cnt[-1, -1] = nnz + 2
    return (idx, cnt, *listed_blocks(idx, cnt, n_kb))


def _full_causal_lists(bh, n_qb, device):
    import torch
    idx = torch.arange(n_qb, dtype=torch.int32, device=device)
    idx = idx.expand(bh, n_qb, n_qb).contiguous()
    cnt = torch.arange(1, n_qb + 1, dtype=torch.int32, device=device)
    return idx, cnt.expand(bh, n_qb).contiguous()


def _causal_pairs(idx, cnt, q_block, kv_block):
    """The (query, key) pairs that the listed tiles leave unmasked under
    the causal mask: the products' work, counted exactly (a diagonal tile
    holds q_block * (q_block + 1) / 2 of them, a tile above it none)."""
    import torch
    dev = idx.device
    listed = torch.arange(idx.shape[-1], device=dev) < cnt[..., None]
    qb = torch.arange(idx.shape[1], device=dev)[None, :, None]
    off = (qb * q_block - idx.long() * kv_block)[listed]
    off, n = torch.unique(off, return_counts=True)
    rows = torch.arange(1, q_block + 1, device=dev)
    per_tile = (off[:, None] + rows).clamp(0, kv_block).sum(1)
    return int((per_tile * n).sum())


def sparse_prefill_kept(q, k, v, mass, **blocks):
    """ops.sparse_prefill_attention(q, k, v, **blocks) as a user calls it,
    with the arguments it hands the kernel observed (not changed); returns
    (out, cnt, the kernel's args, block-sparse launches during the call,
    wall seconds)."""
    import torch
    from repro_torch.kernels.block_sparse_attn import kernel as BK
    from repro_torch.kernels.block_sparse_attn import ops as BO
    seen = {}
    launch = BK.block_sparse_attention

    def launch_and_keep(*args, **kw):
        seen["args"] = args
        return launch(*args, **kw)

    before = BK.LAUNCHES["block_sparse_attention"]
    BK.block_sparse_attention = launch_and_keep
    try:
        t0 = time.perf_counter()
        out, cnt = BO.sparse_prefill_attention(q, k, v, mass=mass,
                                               **blocks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        BK.block_sparse_attention = launch
    return (out, cnt, seen["args"],
            BK.LAUNCHES["block_sparse_attention"] - before, wall)


def block_sparse_vs_sdpa(qf, kf, vf, idx, cnt, g, qb, flush, kb=None):
    """The bf16 block-sparse kernel (q-blocks of qb rows, kv blocks of kb,
    default qb) and SDPA under the same token mask (the listed tiles,
    causal), timed in turns, and the kernel's bound terms: bytes (q, k, v,
    o and the lists moved once) and operations (4 d, QK^T and PV, for each
    (query, key) pair the listed tiles leave to the causal mask). Returns
    (ms, library ms, bytes, operations)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.block_sparse_attn import kernel as BK
    from repro_torch.kernels.block_sparse_attn.ref import block_mask_dense
    kb = kb or qb
    bh, n_tokens, d = qf.shape
    q4, k4, v4 = (x.view(1, -1, n_tokens, d) for x in (qf, kf, vf))
    tok = block_mask_dense(idx, cnt, n_tokens // qb, n_tokens // kb)
    tok = tok.repeat_interleave(qb, 1).repeat_interleave(kb, 2)
    tok &= torch.ones(n_tokens, n_tokens, dtype=torch.bool,
                      device=qf.device).tril()
    mask = tok.view(1, bh, n_tokens, n_tokens)
    ms, lib_ms = time_in_turns(
        lambda: BK.block_sparse_attention(qf, kf, vf, idx, cnt, kv_group=g,
                                          q_block=qb, kv_block=kb),
        lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                               enable_gqa=True), flush)
    nbytes = ((2 * qf.numel() + kf.numel() + vf.numel()) * qf.element_size()
              + (idx.numel() + cnt.numel()) * 4)
    return ms, lib_ms, nbytes, 4 * d * _causal_pairs(idx, cnt, qb, kb)


def decode_vs_sdpa(q, k, v, n, flush):
    """The decode kernel at kv_len n and SDPA (``enable_gqa``) over the
    same n keys, timed in turns, and the kernel's bound terms: bytes (the
    n valid keys and values, q and the output moved once) and operations
    (4 d a query head and key). Returns (ms, library ms, bytes,
    operations)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn import kernel as DK
    b, hq, d = q.shape
    hkv = k.shape[2]
    bq, bk, bv = (q.view(b, hq, 1, d), k[:, :n].transpose(1, 2),
                  v[:, :n].transpose(1, 2))
    ms, lib_ms = time_in_turns(
        lambda: DK.decode_attention(q, k, v, n),
        lambda: F.scaled_dot_product_attention(bq, bk, bv, enable_gqa=True),
        flush)
    nbytes = (2 * b * n * hkv * d + 2 * b * hq * d) * k.element_size()
    return ms, lib_ms, nbytes, 4 * b * hq * n * d


def path_c(cfg, params, err, device, *, n_tokens=8192, seed=0):
    """Sparse prefill attention at full width on layer 0's q/k/v; returns
    (launches during the path, the kernel's perf entry)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import SparKVConfig
    from repro_torch.kernels.block_sparse_attn import kernel as BK
    from repro_torch.kernels.block_sparse_attn import ops as BO
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import unstack

    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          size=(1, n_tokens)), device=device)
    bp = unstack(params["blocks"])[0]
    h = L.apply_norm(cfg, params["emb"][tokens], bp["attn_norm"])
    q, k, v = L.attention_qkv(cfg, bp["attn"], h,
                              torch.arange(n_tokens, device=device))
    hq, hkv, d = q.shape[2], k.shape[2], q.shape[3]
    g, qb = hq // hkv, 128
    n_qb = n_tokens // qb
    mass = SparKVConfig().attention_mass
    print(f"[path C] layer 0 q {tuple(q.shape)} k/v {tuple(k.shape)} "
          f"{q.dtype}; {n_qb} q-blocks, mass {mass}", flush=True)

    BK.reset_launches()
    out, cnt, (qf, kf, vf, idx, cnt2), launches, wall = sparse_prefill_kept(
        q, k, v, mass)
    check(launches == 1, f"path C: {launches} block-sparse launches, not 1")
    tiles = int(cnt.sum())
    causal_tiles = hq * n_qb * (n_qb + 1) // 2
    print(f"[path C] sparse_prefill_attention {wall:.3f} s (masks + "
          f"kernel, first call), active blocks {tiles} of {causal_tiles} "
          f"causal ({tiles / causal_tiles:.4f})", flush=True)
    plain = BK.block_sparse_attention_plain(qf, kf, vf, idx, cnt2,
                                            kv_group=g)
    _compare_close(err, "block_sparse_attention",
                   out.transpose(1, 2).reshape(hq, n_tokens, d), plain,
                   "bfloat16", "path C sparse vs plain")

    full_idx, full_cnt = _full_causal_lists(hq, n_qb, device)
    full = BK.block_sparse_attention(qf, kf, vf, full_idx, full_cnt,
                                     kv_group=g)
    flash = L.flash_attention(q, k, v, causal=True)
    _compare_close({}, "block_sparse_attention", full,
                   BO.heads_first(flash), "bfloat16",
                   "path C full list vs flash_attention")
    del full, flash, plain

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    plain_ms = time_ms(lambda: BK.block_sparse_attention_plain(
        qf, kf, vf, idx, cnt2, kv_group=g), flush)
    ms, lib_ms, nbytes, ops = block_sparse_vs_sdpa(qf, kf, vf, idx, cnt2, g,
                                                   qb, flush)
    q4, k4, v4 = (x.view(1, -1, n_tokens, d) for x in (qf, kf, vf))
    full_ms, dense_ms = time_in_turns(
        lambda: BK.block_sparse_attention(qf, kf, vf, full_idx, full_cnt,
                                          kv_group=g),
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                               enable_gqa=True), flush)
    pairs = ops // (4 * d)
    perf = _perf(err["block_sparse_attention"], ms, plain_ms, lib_ms,
                 nbytes, ops, BF16_FLOPS)
    print(f"[path C] block_sparse_attention {tiles} tiles, {pairs} causal "
          f"pairs: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, SDPA with "
          f"the block mask {lib_ms:.6f} ms, bound {perf['bound_ms']:.6f} ms "
          f"({perf['bound_by']}, {ops:.4g} operations, {nbytes} B); "
          f"kernel {ops / ms / 1e9:.1f} TFLOP/s, "
          f"{perf['bound_ms'] / ms:.1%} of its bound")
    full_ops = 4 * d * _causal_pairs(full_idx, full_cnt, qb, qb)
    full_bound = full_ops / BF16_FLOPS * 1e3
    print(f"[path C] dense causal SDPA (is_causal=True): {dense_ms:.6f} ms; "
          f"kernel over the full causal list ({causal_tiles} tiles): "
          f"{full_ms:.6f} ms, bound {full_bound:.6f} ms "
          f"({full_ops:.4g} operations), {full_ops / full_ms / 1e9:.1f} "
          f"TFLOP/s, {full_bound / full_ms:.1%} of its bound", flush=True)
    return launches, perf


# (q_block, kv_block) of the sweep: the serve CLI's and the quality
# bench's 32, the serving tests' 16, a block of one and a half sub-tiles,
# and path C's 128 at the same length for reference
BLOCK_SWEEP = ((16, 16), (32, 32), (96, 96), (128, 128))


def block_size_sweep(err, device, *, hq=32, hkv=8, d=128, n_tokens=1536,
                     seed=0):
    """sparse_prefill_attention at the block sizes of BLOCK_SWEEP, at
    sparkv-qwen3-4b's head shape, b = 1, seeded random q/k/v over
    n_tokens (a multiple of 96 and 128), causal at the serving mass: each
    call one launch, held against its plain version on the lists it
    handed the kernel, bf16 and fp32; bf16 timed beside its bound and SDPA
    under the same token mask. Returns the launches."""
    import torch
    from repro_torch.configs import SparKVConfig
    from repro_torch.kernels.block_sparse_attn import kernel as BK

    mass, g = SparKVConfig().attention_mass, hq // hkv
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    base = [torch.randn((1, n_tokens, h, d), generator=gen, device=device)
            for h in (hq, hkv, hkv)]
    launches = 0
    for qb, kb in BLOCK_SWEEP:
        for dn, dt in (("bfloat16", torch.bfloat16),
                       ("float32", torch.float32)):
            label = f"blocks ({qb}, {kb}) {hq}/{hkv}x{d} {dn}"
            q, k, v = (x.to(dt) for x in base)
            out, _, (qf, kf, vf, idx, cnt), n, _ = sparse_prefill_kept(
                q, k, v, mass, q_block=qb, kv_block=kb)
            check(n == 1, f"path C {label}: {n} block-sparse launches")
            launches += n
            out = out.transpose(1, 2).reshape(hq, n_tokens, d)
            plain = BK.block_sparse_attention_plain(
                qf, kf, vf, idx, cnt, kv_group=g, q_block=qb, kv_block=kb)
            _compare_close(err, "block_sparse_attention", out, plain, dn,
                           f"path C {label} sparse vs plain")
            e = _max_err(out, plain)
            del q, k, v, out, plain
            if dt != torch.bfloat16:
                print(f"[path C] {label}: err vs plain {e:.3e}", flush=True)
                continue
            ms, lib, nbytes, ops = block_sparse_vs_sdpa(
                qf, kf, vf, idx, cnt, g, qb, flush, kb=kb)
            p = _perf(e, ms, None, lib, nbytes, ops, BF16_FLOPS)
            print(f"[path C] {label}: {int(cnt.sum())} tiles, kernel "
                  f"{ms:.6f} ms, bound {p['bound_ms']:.6f} ms "
                  f"({p['bound_by']}, {p['bound_ms'] / ms:.1%}), SDPA with "
                  f"the block mask {lib:.6f} ms; err vs plain {e:.3e}",
                  flush=True)
    return launches


def path_d(cache, hq, err, device, *, seed=0):
    """Decode attention over path A's assembled cache, one call per
    layer; returns (launches during the path, the kernel's perf entry)."""
    import torch
    from repro_torch.kernels.decode_attn import kernel as DK
    from repro_torch.kernels.decode_attn import ops as DO
    from repro_torch.models import layers as L

    ck, cv = cache["k"], cache["v"]
    n_l, b, skv, hkv, d = ck.shape
    kv_len = skv
    gen = torch.Generator(device=device).manual_seed(seed)
    qs = torch.randn((n_l, b, hq, d), generator=gen,
                     device=device).to(ck.dtype)
    print(f"[path D] cache k/v {tuple(ck.shape)} {ck.dtype}, q "
          f"{tuple(qs.shape[1:])}, kv_len {kv_len}", flush=True)
    DK.reset_launches()
    outs = [DO.decode_attention(qs[i], ck[i], cv[i], kv_len)
            for i in range(n_l)]
    torch.cuda.synchronize()
    launches = DK.LAUNCHES["decode_attention"]
    check(launches == n_l,
          f"path D: {launches} decode kernel launches, not one for each of "
          f"{n_l} calls")
    e_plain = e_flash = 0.0
    ok = True
    for i, out in enumerate(outs):
        plain = DK.decode_attention_plain(qs[i], ck[i], cv[i], kv_len)
        flash = L.flash_attention(qs[i][:, None], ck[i], cv[i],
                                  causal=False)[:, 0]
        ep, ef = _max_err(out, plain), _max_err(out, flash)
        ok &= (ep <= _tolerance(plain, "bfloat16")
               and ef <= _tolerance(flash, "bfloat16"))
        e_plain, e_flash = max(e_plain, ep), max(e_flash, ef)
        check(bool(torch.isfinite(out.float()).all()),
              f"path D: layer {i} not finite")
    err["decode_attention"] = max(err.get("decode_attention", 0.0), e_plain)
    print(f"[path D] {n_l} layers: max |err| vs plain {e_plain:.3e}, vs "
          f"layers.flash_attention {e_flash:.3e} (bf16 atol 2e-2 scaled by "
          f"each reference's largest magnitude under 1)")
    check(ok, "path D beyond tolerance")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def timings(q, k, v, n):
        ms, lib_ms, nbytes, _ = decode_vs_sdpa(q, k, v, n, flush)
        plain_ms = time_ms(lambda: DK.decode_attention_plain(q, k, v, n),
                           flush)
        return ms, plain_ms, lib_ms, nbytes

    def rate(nbytes, ms):
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        return (f"{nbytes / ms / 1e9:.3f} TB/s, {bound / ms:.1%} of its "
                "bound")

    ms, plain_ms, lib_ms, nbytes = timings(qs[0], ck[0], cv[0], kv_len)
    perf = _perf(err["decode_attention"], ms, plain_ms, lib_ms, nbytes,
                 4 * b * hq * kv_len * d, BF16_FLOPS)
    print(f"[path D] decode_attention kv_len {kv_len}: kernel {ms:.6f} ms, "
          f"plain {plain_ms:.6f} ms, SDPA {lib_ms:.6f} ms, bound "
          f"{perf['bound_ms']:.6f} ms ({perf['bound_by']}, {nbytes} B); "
          f"kernel {rate(nbytes, ms)}")

    # one long cache: 32768 positions, 32000 valid; in fp32 too, where the
    # tolerance would catch a dropped or misweighted block
    long_skv, long_len = 32768, 32000
    k = torch.randn((b, long_skv, hkv, d), generator=gen, device=device)
    v = torch.randn((b, long_skv, hkv, d), generator=gen, device=device)
    q32 = qs[0].float()
    _compare_close(err, "decode_attention",
                   DK.decode_attention(q32, k, v, long_len),
                   DK.decode_attention_plain(q32, k, v, long_len), "float32",
                   f"long cache skv {long_skv} len {long_len} float32")
    k, v = k.to(ck.dtype), v.to(ck.dtype)
    out = DK.decode_attention(qs[0], k, v, long_len)
    _compare_close(err, "decode_attention", out,
                   DK.decode_attention_plain(qs[0], k, v, long_len),
                   "bfloat16", f"long cache skv {long_skv} len {long_len}")
    lms, lplain, llib, lbytes = timings(qs[0], k, v, long_len)
    print(f"[path D] decode_attention kv_len {long_len}: kernel "
          f"{lms:.6f} ms, plain {lplain:.6f} ms, SDPA {llib:.6f} ms, bound "
          f"{lbytes / HBM_BYTES_PER_S * 1e3:.6f} ms (bytes, {lbytes} B); "
          f"kernel {rate(lbytes, lms)}", flush=True)
    perf["max_abs_err"] = err["decode_attention"]
    return launches, perf


def attention_configs():
    """Every config of repro_torch.configs that has attention, with its
    (hq, hkv, head_dim)."""
    from repro_torch.configs import ASSIGNED_ARCHS, get_config
    out = []
    for arch in ["sparkv-qwen3-4b", *ASSIGNED_ARCHS]:
        cfg = get_config(arch)
        if cfg.has_attention:
            out.append((arch, cfg.num_heads, cfg.num_kv_heads,
                        cfg.resolved_head_dim))
    return out


def path_k(err, device, *, n_tokens=2048, long_len=32000, seed=0):
    """Both attention kernels at the head shapes of every attention-bearing
    config, at full width, b = 1: sparse_prefill_attention over n_tokens
    (causal, SparKVConfig().attention_mass, 128-token blocks) and
    decode_attention at kv_len n_tokens and long_len, each call one launch
    held against its plain version on the same inputs (and the same block
    lists); bf16 timed beside its bound and SDPA, fp32 checked at n_tokens
    only; prints a row a config and dtype (PERF.md's path K table).
    Returns the launches by kernel."""
    import torch
    from repro_torch.configs import SparKVConfig
    from repro_torch.kernels.block_sparse_attn import kernel as BK
    from repro_torch.kernels.decode_attn import kernel as DK
    from repro_torch.kernels.decode_attn import ops as DO

    mass, qb = SparKVConfig().attention_mass, 128
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    launches = {"block_sparse_attention": 0, "decode_attention": 0}
    rows = []
    for i, (arch, hq, hkv, d) in enumerate(attention_configs()):
        gen = torch.Generator(device=device).manual_seed(seed + i)
        g = hq // hkv
        for dn, dt in (("bfloat16", torch.bfloat16),
                       ("float32", torch.float32)):
            label = f"{arch} {hq}/{hkv}x{d} {dn}"
            q, k, v = (torch.randn((1, n_tokens, h, d), generator=gen,
                                   device=device).to(dt)
                       for h in (hq, hkv, hkv))
            out, _, (qf, kf, vf, idx, cnt), n, _ = sparse_prefill_kept(
                q, k, v, mass)
            check(n == 1, f"path K {label}: {n} block-sparse launches")
            launches["block_sparse_attention"] += n
            out = out.transpose(1, 2).reshape(hq, n_tokens, d)
            plain = BK.block_sparse_attention_plain(qf, kf, vf, idx, cnt,
                                                    kv_group=g)
            _compare_close(err, "block_sparse_attention", out, plain, dn,
                           f"path K {label} sparse vs plain")
            e_bsa = _max_err(out, plain)
            del q, k, v, out, plain
            lens = (n_tokens, long_len) if dt == torch.bfloat16 \
                else (n_tokens,)
            dq = torch.randn((1, hq, d), generator=gen, device=device).to(dt)
            dk, dv = (torch.randn((1, lens[-1], hkv, d), generator=gen,
                                  device=device).to(dt) for _ in range(2))
            e_dec = {}
            for n_len in lens:
                before = DK.LAUNCHES["decode_attention"]
                out = DO.decode_attention(dq, dk, dv, n_len)
                n = DK.LAUNCHES["decode_attention"] - before
                check(n == 1, f"path K {label}: {n} decode launches")
                launches["decode_attention"] += n
                plain = DK.decode_attention_plain(dq, dk, dv, n_len)
                _compare_close(err, "decode_attention", out, plain, dn,
                               f"path K {label} decode len {n_len}")
                e_dec[n_len] = _max_err(out, plain)
            if dt != torch.bfloat16:
                rows.append(dict(arch=arch, dtype=dn, hq=hq, hkv=hkv, d=d,
                                 bsa_err=e_bsa, dec_err=e_dec))
                continue
            row = dict(arch=arch, dtype=dn, hq=hq, hkv=hkv, d=d,
                       bsa_err=e_bsa, dec_err=e_dec,
                       tiles=int(cnt.sum()))
            ms, lib, nbytes, ops = block_sparse_vs_sdpa(qf, kf, vf, idx, cnt,
                                                        g, qb, flush)
            row["bsa"] = _perf(e_bsa, ms, None, lib, nbytes, ops,
                               BF16_FLOPS)
            for n_len in lens:
                ms, lib, nbytes, ops = decode_vs_sdpa(dq, dk, dv, n_len,
                                                      flush)
                row[f"dec{n_len}"] = _perf(e_dec[n_len], ms, None, lib,
                                           nbytes, ops, BF16_FLOPS)
            rows.append(row)
            del qf, kf, vf, idx, cnt, dq, dk, dv
    for r in rows:
        errs = (f"err vs plain: block-sparse {r['bsa_err']:.3e}, decode "
                + ", ".join(f"{e:.3e} (len {n})"
                            for n, e in r["dec_err"].items()))
        if "bsa" not in r:
            print(f"[path K] {r['arch']:22s} {r['hq']}/{r['hkv']}x{r['d']} "
                  f"{r['dtype']}: {errs}")
            continue
        cells = []
        for key, what in (("bsa", f"block-sparse {r['tiles']} tiles"),
                          *((f"dec{n}", f"decode len {n}") for n in
                            r["dec_err"])):
            p = r[key]
            cells.append(f"{what}: kernel {p['ms']:.6f} ms, bound "
                         f"{p['bound_ms']:.6f} ms ({p['bound_by']}, "
                         f"{p['bound_ms'] / p['ms']:.1%}), SDPA "
                         f"{p['library_ms']:.6f} ms")
        print(f"[path K] {r['arch']:22s} {r['hq']}/{r['hkv']}x{r['d']} "
              f"{r['dtype']}: " + "; ".join(cells) + f"; {errs}")
    return launches


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

    assemble = srv.assemble

    def assemble_and_keep(st, streamed):
        k, v = assemble(st, streamed)
        seen["assembled"] = (st, list(streamed), k, v)
        return k, v

    srv.load_context = load_and_keep
    srv._decode = decode_and_check
    srv.assemble = assemble_and_keep
    return srv, seen


def serve_path(label, cfg, spcfg, n_tokens, policies, device, *, seed=0,
               max_new=8, keep=None):
    """Register one context and serve one request per policy; returns the
    kernels' launches during the path, reset just before it. `keep`, a
    dict, receives the server's params and the cache of the first request
    that streamed chunks."""
    from repro_torch.device import sync
    from repro_torch.kernels.kv_dequant import kernel as K

    rng = np.random.default_rng(seed)
    srv, seen = build_server(cfg, spcfg, device, seed)
    if keep is not None:
        keep["params"], keep["server"], keep["seen"] = srv.params, srv, seen
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
    if keep is not None:
        keep["context"], keep["cid"] = st, cid
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
        print(f"[{label}] {policy:13s} dequant phase "
              f"{split.get('dequant', 0.0):.6f} s for {res.n_streamed} "
              f"streamed chunks, launches {launched}", flush=True)
        check(res.n_streamed + res.n_computed == st.n_chunks,
              f"{policy}: streamed + computed != {st.n_chunks}")
        check(seen.get("finite") and seen["n_logits"] == 2 * max_new,
              f"{policy}: non-finite logits")
        check(math.isfinite(res.mean_kl), f"{policy}: KL not finite")
        if policy == "local_prefill":
            check(res.n_streamed == 0 and res.top1_agreement == 1.0,
                  "local_prefill must match the exact cache")
        if res.n_streamed:
            cache = seen["cache"]
            err = max(float((cache["k"].float() - ex_k).abs().max()),
                      float((cache["v"].float() - ex_v).abs().max()))
            print(f"[{label}] {policy} cache max |err| {err:.6f} "
                  f"(bound {2 * step_bound + 1e-4:.6f})")
            check(err <= 2 * step_bound + 1e-4,
                  f"{policy} cache beyond two quantization steps")
            if keep is not None and "cache" not in keep:
                keep["cache"] = cache
        widths = {q.bits for c in seen["res"].engine.streamed_set
                  for q in st.encoded[c][2:]}
        yield policy, res, launched, widths


def dequant_routes(srv, st, device, *, turns=2):
    """Host-clock seconds of dequantizing every chunk of a stored context
    into fresh copies of its cache (a cachegen request's dequant phase,
    Huffman decoding left out: the stored codes are what it returns),
    two ways in turns (old, new, new, old, ...): the per-chunk route that
    one staged launch replaced, a launch per K or V chunk tensor through
    the row form after three pageable copies of its packed rows, and a
    slice copy of each output into the cache; and the route load_context
    takes, one staged batch and one launch."""
    import torch
    from repro_torch.kernels.kv_dequant import kernel as K
    from repro_torch.kernels.kv_dequant import ops as KO

    ct = srv.chunk_tokens
    chunks = sorted(st.encoded)
    qts = [q for c in chunks for q in st.encoded[c][2:]]

    def old(k, v):
        for c in chunks:
            for q, x in zip(st.encoded[c][2:], (k, v)):
                n, g = int(np.prod(q.shape)), q.scales.shape[0]
                check(n == g * q.group and g % 8 == 0,
                      "old route: chunk not whole rows of 8 groups")
                codes, scales, zeros = (
                    torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in (q.codes.reshape(g // 8, 8 * q.group),
                              q.scales.reshape(g // 8, 8),
                              q.zeros.reshape(g // 8, 8)))
                out = K.kv_dequant(codes, scales, zeros, group=q.group,
                                   out_dtype=torch.float32)
                x[c.l, 0, c.t * ct:(c.t + 1) * ct] = out.reshape(q.shape)

    def new(k, v):
        # dequantize_into, with the staging (host fill of the pinned
        # buffer, copy enqueued) timed on its own
        t0 = time.perf_counter()
        b = KO.stage(qts, [x[c.l, 0, c.t * ct:(c.t + 1) * ct]
                           for c in chunks for x in (k, v)],
                     mixed=len({q.bits for q in qts}) > 1)
        staged.append(time.perf_counter() - t0)
        KO.dequant_batch(b)

    times, staged = {"old": [], "new": []}, []
    caches = {}
    for name in ("old", "new", "new", "old") * turns:
        k, v = st.exact_k.clone(), st.exact_v.clone()
        torch.cuda.synchronize()
        before = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        (old if name == "old" else new)(k, v)
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
        n = K.LAUNCHES["kv_dequant"] - before["kv_dequant"]
        check(n == (len(qts) if name == "old" else 1),
              f"{name} route: {n} kv_dequant launches")
        caches[name] = (k, v)
    same = all(_bits_equal(a, b) for a, b in zip(caches["old"],
                                                 caches["new"]))
    print(f"[path A] dequant of {len(qts)} chunk tensors, host clock, in "
          f"turns: per-chunk route (a launch each + slice copy) "
          f"{', '.join(f'{t:.6f}' for t in times['old'])} s; one staged "
          f"launch {', '.join(f'{t:.6f}' for t in times['new'])} s, of "
          f"which staging {', '.join(f'{t:.6f}' for t in staged)} s; "
          f"caches bit-equal={same}", flush=True)
    check(same, "the two dequant routes assemble different caches")


# ----------------------------------------------------------------------------
# path E: the fleet stack
# ----------------------------------------------------------------------------


class Clock:
    """Counts the calls of one object's method and their host-clock
    seconds, with a device synchronise before and after each call, so a
    call's time is its own. Installed on the instance, removed on exit."""

    def __init__(self, obj, method, device):
        self.obj, self.method, self.device = obj, method, device
        self.calls, self.seconds = 0, 0.0

    def __enter__(self):
        from repro_torch.device import sync
        inner = getattr(self.obj, self.method)

        def timed(*args, **kw):
            sync(self.device)
            t0 = time.perf_counter()
            try:
                return inner(*args, **kw)
            finally:
                sync(self.device)
                self.seconds += time.perf_counter() - t0
                self.calls += 1
        setattr(self.obj, self.method, timed)
        return self

    def __exit__(self, *exc):
        delattr(self.obj, self.method)

    def __str__(self):
        per = self.seconds / self.calls * 1e3 if self.calls else 0.0
        return (f"{self.calls} calls, {self.seconds:.6f} s "
                f"({per:.6f} ms a call)")


def fleet_fingerprint(report):
    """Every per-request observable of a fleet report, exactly as
    produced (the tuple of tests/test_simcore.py::_fleet_fingerprint)."""
    return [(r.spec.arrival_s, r.ttft_s, r.ttlt_s, r.energy_j,
             r.uplink_share,
             r.compute_wait_s, r.bytes_streamed, r.policy,
             tuple(sorted(r.stage_shares.items())))
            for r in report.records]


def _print_fleet(label, rep):
    """The fleet simulator's own metrics (its virtual clock, not the
    card's), and the checks every fleet report must pass."""
    s = rep.summary()
    print(f"[{label}] (simulated) {s['n_done']} served of {rep.n_arrived}: "
          f"TTFT p50 {s['ttft_p50_s']:.6f} s, p99 {s['ttft_p99_s']:.6f} s; "
          f"SLO attainment {s['slo_attainment']}; shed {s['n_shed']}, "
          f"downgraded {s['n_downgraded']}; energy "
          f"{s['energy_per_req_j']:.3f} J a request; makespan "
          f"{rep.makespan_s:.6f} s", flush=True)
    check(len(rep.records) + len(rep.shed) == rep.n_arrived,
          f"{label}: served + shed != arrived")
    check(rep.records, f"{label}: the fleet served nothing")
    check(all(math.isfinite(r.ttft_s) and r.ttft_s > 0
              and math.isfinite(r.energy_j) for r in rep.records),
          f"{label}: a request's TTFT or energy is not finite and positive")
    return s


def path_e1(srv, cid, device, *, n_jobs=32, rate_rps=2.0, seed=0):
    """SparKVServer.serve_fleet on path A's server and context, then one
    load_context of a streaming policy the fleet admitted (sparkv where
    it did); returns (policy, streamed chunks, kv_dequant launches) a
    load."""
    from repro_torch.core import baselines as TB
    from repro_torch.core.costs import RunQueueModel
    from repro_torch.kernels.kv_dequant import kernel as K
    from repro_torch.serving.slo import SLOPolicy

    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, n_jobs))
    policies = ("sparkv", "strong_hybrid", "cachegen", "local_prefill")
    jobs = [(cid, float(a), policies[i % len(policies)])
            for i, a in enumerate(arrivals)]
    n_tokens = srv.contexts[cid].wl.context_len
    print(f"[path E1] serve_fleet: {n_jobs} jobs on the {n_tokens}-token "
          f"context, Poisson {rate_rps}/s (seed {seed}), policies "
          f"{', '.join(policies)}; WFQ run queue of 2, SLO admission, "
          "deadline 4 s, 8 new tokens a request", flush=True)
    srv._ensure_predictor()
    pred = TB._PRED_CACHE[(srv.model.cfg.name, srv.profile)]
    check(pred.device.type == device.type,
          f"path E1: the planner lives on {pred.device}, not {device}")
    with Clock(pred, "predict_ms", device) as mlp:
        t0 = time.perf_counter()
        rep = srv.serve_fleet(jobs, run_queue=RunQueueModel(2, "wfq"),
                              slo=SLOPolicy(), deadline_s=4.0,
                              max_new_tokens=8)
        wall = time.perf_counter() - t0
    _print_fleet("path E1", rep)
    print(f"[path E1] card and host: fleet wall {wall:.6f} s; planner MLP "
          f"on {pred.device}: {mlp}; simulator {rep.makespan_s:.6f} s of "
          f"virtual time", flush=True)
    check(mlp.calls >= len(rep.records), "path E1: fewer planner calls than "
          "admitted requests")
    planner_call_split(pred, srv.contexts[cid].wl, device)

    # one load, sparkv's where the fleet admitted it: each load spends
    # tens of seconds in host Huffman decode (PERF.md section 4)
    streaming = sorted({r.policy for r in rep.records} - {"local_prefill"})
    loads = []
    for policy in ["sparkv"] if "sparkv" in streaming else streaming[:1]:
        before = dict(K.LAUNCHES)
        phases = dict(srv.phase_s)
        t0 = time.perf_counter()
        _, res = srv.load_context(cid, policy=policy, seed=1)
        wall = time.perf_counter() - t0
        launched = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
        split = {k: srv.phase_s[k] - phases.get(k, 0.0) for k in srv.phase_s
                 if srv.phase_s[k] - phases.get(k, 0.0)}
        n = res.engine.n_streamed
        print(f"[path E1] load_context {policy:13s} streamed {n}/computed "
              f"{res.engine.n_computed}, wall {wall:.3f} s ("
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + f"), launches {launched}", flush=True)
        loads.append((policy, n, launched))
    return loads


def planner_call_split(pred, wl, device, *, n=200):
    """Host-clock median of one planner call (t_comp_batch over the
    context's whole chunk grid, as an admission makes it) with the MLP
    on `device`, and with a copy of the same MLP on the host CPU: what
    the per-admission device round trip costs."""
    import copy

    import torch
    t_idx = np.repeat(np.arange(wl.n_t, dtype=float), wl.n_l)
    layers = np.tile(np.arange(wl.n_l), wl.n_t)
    act = wl.active_blocks[:, :, 0].reshape(-1).astype(float)
    host = copy.copy(pred)
    host.params = [{k: t.cpu() for k, t in lyr.items()} for lyr in pred.params]
    host.device = torch.device("cpu")
    times = {}
    outs = {}
    for name, p in (("device", pred), ("host", host), ("host", host),
                    ("device", pred)):
        ts = []
        for _ in range(n // 2):
            t0 = time.perf_counter()
            outs[name] = p.t_comp_batch(t_idx, layers, act, 0.3)
            ts.append(time.perf_counter() - t0)
        times.setdefault(name, []).extend(ts)
    err = float(np.abs(outs["device"] - outs["host"]).max()
                / np.abs(outs["host"]).max())
    med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    print(f"[path E1] one planner call over {len(act)} chunks, host clock, "
          f"median of {n} in turns: MLP on {pred.device} {med['device']:.6f} "
          f"ms, the same MLP on the host CPU {med['host']:.6f} ms "
          f"(largest relative difference {err:.2e})", flush=True)
    check(err <= 1e-5, "path E1: the planner MLP on the host disagrees with "
          "the one on the card")


def path_e2(cfg, device, *, n_requests=256, seed=42):
    """A standalone ServingCluster with the planner cache filled on the
    card: the traffic mix of examples/serve_fleet.py at n_requests, 4
    devices and 2 APs, memory pressure, the cloud KV store, a handoff
    storm with the rebalancer and the online refresh; run twice."""
    from repro_torch.configs import SparKVConfig
    from repro_torch.core import baselines as TB
    from repro_torch.core.costs import (PROFILES, KVStoreModel, MemoryModel,
                                        RunQueueModel)
    from repro_torch.core.predictor import LatencyPredictor
    from repro_torch.serving.cluster import ServingCluster
    from repro_torch.serving.decode import DecodeConfig
    from repro_torch.serving.scenarios import (FleetRebalancer,
                                               ScenarioTrace, handoff_storm)
    from repro_torch.serving.slo import SLOPolicy
    from repro_torch.serving.traffic import TrafficProfile, generate_trace

    profile = TrafficProfile(
        rate_rps=1.0, arrival="bursty", burst_factor=6.0, n_devices=4,
        context_mix=(("longchat", 0.6), ("triviaqa", 0.4)),
        policy_mix=(("sparkv", 0.6), ("strong_hybrid", 0.25),
                    ("local_prefill", 0.15)),
        max_context=4096, out_len_mix=((16, 0.6), (32, 0.4)),
        slo_mix=(("interactive", 8.0, 0.6), ("batch", None, 0.4)),
        prefix_pool=6, prefix_zipf_a=1.2, prefix_frac=0.5)
    specs = generate_trace(profile, n_requests, seed=seed)
    mem_cap = 1e9
    pred = TB._PRED_CACHE[(cfg.name, "jetson-orin")]
    check(pred.device.type == device.type,
          f"path E2: the planner lives on {pred.device}, not {device}")
    print(f"[path E2] ServingCluster({cfg.name}): {n_requests} requests "
          f"(bursty, seed {seed}) over {specs[-1].arrival_s:.3f} s, 4 "
          f"devices / 2 APs, WFQ 2 slots, decode batch 8, memory "
          f"{mem_cap:.3g} B a device, cloud KV store 4 GiB, handoff storm "
          f"+ FleetRebalancer, refresh every 16 on {device}", flush=True)
    prints = []
    for run in (1, 2):
        refresh = LatencyPredictor(cfg, PROFILES["jetson-orin"],
                                   device=device)
        rebalancer = FleetRebalancer(refresh)
        cluster = ServingCluster(
            cfg, SparKVConfig(scheduler_mode="engine"), "jetson-orin",
            "campus-wifi", n_devices=4, n_aps=2, max_concurrency=16,
            run_queue=RunQueueModel(2, "wfq"),
            decode=DecodeConfig(max_batch=8),
            memory=MemoryModel(capacity_bytes=mem_cap),
            kvstore=KVStoreModel(capacity_bytes=float(4 << 30),
                                 device_capacity_bytes=float(8 << 30)),
            slo=SLOPolicy(),
            scenario=ScenarioTrace(handoffs=handoff_storm(
                4, 2, t_start_s=5.0, spacing_s=2.0)),
            rebalancer=rebalancer, predictor=refresh, refresh_every=16)
        with Clock(pred, "predict_ms", device) as mlp, \
                Clock(rebalancer, "decide", device) as lp:
            t0 = time.perf_counter()
            rep = cluster.run(specs)
            wall = time.perf_counter() - t0
        _print_fleet(f"path E2 run {run}", rep)
        st = cluster.last_sim_stats
        print(f"[path E2 run {run}] card and host: fleet wall {wall:.6f} s; "
              f"simulator {st['n_events']} events in {st['wall_s']:.6f} s "
              f"({st['events_per_s']:.1f} events/s); planner MLP on "
              f"{pred.device}: {mlp}; rebalancer LP: {lp}", flush=True)
        mem, scen = rep.memory, rep.scenario
        store = rep.reuse["store"]
        print(f"[path E2 run {run}] (simulated) memory: evictions "
              f"{mem['n_evictions']}, reloads {mem['n_reloads']}; store "
              f"hits {store['n_hits']} of {store['n_lookups']}; handoffs "
              f"{scen['n_handoffs']} (+{scen['n_handoff_noop']} no-op), "
              f"rebalances {scen['n_rebalances']}, LP solves "
              f"{scen['n_lp_solves']}; refresh fitted {refresh.refreshed}",
              flush=True)
        check(mem["n_evictions"] > 0, "path E2: the memory budget forced no "
              "eviction")
        check(store["n_hits"] > 0, "path E2: the KV store had no hit")
        check(scen["n_rebalances"] > 0, "path E2: the rebalancer never ran")
        check(refresh.refreshed, "path E2: the online refresh never fitted")
        check(mlp.calls >= n_requests - len(rep.shed),
              "path E2: fewer planner calls than admitted requests")
        prints.append(fleet_fingerprint(rep))
    check(prints[0] == prints[1],
          "path E2: two runs of the same fleet differ")
    print(f"[path E2] fingerprints of the two runs equal ({len(prints[0])} "
          "records)", flush=True)


# ----------------------------------------------------------------------------
# paths F and G: the MoE, SSM and hybrid families
# ----------------------------------------------------------------------------


def free_card():
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def plain_assembly_check(seen, label):
    """The fp32 cache that load_context assembled (one kv_dequant launch)
    against the plain version's dequant of the same stored chunks into a
    copy of the exact cache: bit for bit."""
    from repro_torch.kernels.kv_dequant import kernel as K
    from repro_torch.kernels.kv_dequant import ops as KO
    st, streamed, k, v = seen["assembled"]
    ct = st.wl.chunk_tokens
    pk, pv = st.exact_k.clone(), st.exact_v.clone()
    K.dequant_batch_plain(KO.stage(
        [q for c in streamed for q in st.encoded[c][2:]],
        [x[c.l, 0, c.t * ct:(c.t + 1) * ct] for c in streamed
         for x in (pk, pv)], mixed=False))
    same = _bits_equal(k, pk) and _bits_equal(v, pv)
    err = max(_max_err(k, pk), _max_err(v, pv))
    print(f"[{label}] assembled cache of {len(streamed)} streamed chunks vs "
          f"the plain dequant of the same stored chunks: bit-equal={same} "
          f"max_abs_err={err}", flush=True)
    check(same, f"{label}: the assembled cache differs from the plain "
          "dequant")
    return err


def moe_drop_rate(srv, tokens, label):
    """Share of the router's assignments past their expert's capacity,
    each MoE layer, over one prefill of the context (a second prefill,
    with each layer's routing counted beside it)."""
    import torch
    from repro_torch.models import layers as L
    inner, dropped = L.moe_block, []

    def counted(cfg, p, x):
        idx = L.moe_gates(cfg, p, x.reshape(-1, x.shape[-1]))[2]
        dropped.append(L.moe_dropped(cfg, idx))
        return inner(cfg, p, x)

    L.moe_block = counted
    try:
        tok = torch.as_tensor(tokens, device=srv.device)
        srv.model.prefill(srv.params, {"tokens": tok})
    finally:
        L.moe_block = inner
    mo = srv.model.cfg.moe
    n = tokens.shape[1] * mo.experts_per_token
    cap = L.moe_capacity(srv.model.cfg, tokens.shape[1])
    print(f"[{label}] MoE prefill of {tokens.shape[1]} tokens: {n} "
          f"assignments a layer over {mo.num_experts} experts, capacity "
          f"{cap} a expert; dropped {sum(dropped)} of {n * len(dropped)} "
          f"({sum(dropped) / (n * len(dropped)):.6f}), per layer min "
          f"{min(dropped)} max {max(dropped)}", flush=True)
    check(len(dropped) == srv.model.cfg.num_layers,
          f"{label}: {len(dropped)} MoE layers routed, not "
          f"{srv.model.cfg.num_layers}")


def path_f(cfg, spcfg, device, *, n_tokens=2048):
    """A MoE model (granite-moe-3b-a800m) through SparKVServer: sparkv and
    local_prefill; returns the kv_dequant launches during the path's
    requests and the largest error of its assembled cache against the
    plain dequant."""
    kept, err = {}, 0.0
    launches = {"kv_dequant": 0, "kv_dequant_mixed": 0}
    for policy, res, launched, widths in serve_path(
            "path F", cfg, spcfg, n_tokens, ("sparkv", "local_prefill"),
            device, keep=kept):
        want = 1 if res.n_streamed else 0
        check(launched == {"kv_dequant": want, "kv_dequant_mixed": 0},
              f"path F {policy}: dequant launches {launched}, not {want} "
              f"kv_dequant for {res.n_streamed} streamed chunks")
        if policy == "sparkv":
            check(res.n_streamed > 0, "path F: sparkv streamed no chunk")
            err = plain_assembly_check(kept["seen"], "path F")
        for k in launched:
            launches[k] += launched[k]
    moe_drop_rate(kept["server"], kept["context"].tokens, "path F")
    kept.clear()
    free_card()
    return launches, err


def cuda_timed(fn):
    """(fn(), ms between CUDA events recorded on the stream before and
    after it)."""
    import torch
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    e.synchronize()
    return out, s.elapsed_time(e)


def count_ops(fn):
    """(fn(), the aten ops it dispatched at the top level: a DTensor op
    counts once, not the local ops it runs)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))
    with Count():
        out = fn()
    return out, Count.n


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _decode_cache(model, pre, n_tokens, device, dtype):
    """The decode cache of a prefill, as tests/test_models.py builds it:
    conv in bf16, state in fp32, the hybrid's attention context and
    tails in the weights' dtype."""
    import torch
    src = pre if model.cfg.family == "ssm" else pre["ssm"]
    ssm = {"conv": src["conv"].to(torch.bfloat16),
           "state": src["state"].float()}
    if model.cfg.family == "ssm":
        return ssm
    from repro_torch.models import hybrid
    cache = hybrid.init_cache(model.cfg, 1, n_tokens, device=device,
                              dtype=dtype)
    cache.update(ssm=ssm, attn_k=pre["attn_k"], attn_v=pre["attn_v"])
    return cache


def decode_vs_prefill(model, params, tokens, n, device):
    """|decode after an n-token prefill - the (n+1)-token prefill's last
    logits|, largest over the vocab."""
    import torch
    _, pre = model.prefill(params, {"tokens": tokens[:, :n]})
    cache = _decode_cache(model, pre, n, device, params["emb"].dtype)
    logits, _ = model.decode_step(params, cache, tokens[:, n], n)
    ref, _ = model.prefill(params, {"tokens": tokens[:, :n + 1]})
    check(bool(torch.isfinite(logits.float()).all()),
          "decode logits not finite")
    return float((logits.float() - ref.float()).abs().max())


def path_g(cfg, device, *, n_tokens=2048, new=8, check_tokens=256, seed=0):
    """A 2048-token prefill and `new` greedy decode steps of one SSM or
    hybrid model, timed with CUDA events; decode against prefill in bf16
    (printed) and on an fp32 copy of the weights at check_tokens (limit
    0.15)."""
    import torch
    from repro_torch.models import build_model
    arch = cfg.name
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed),
                        device=device)
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          size=(1, n_tokens + 1)),
                             device=device)
    print(f"[path G] {arch} ({cfg.family}): {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, ssm state {cfg.ssm.state_dim}, head_dim "
          f"{cfg.ssm.head_dim}, chunk {cfg.ssm.chunk_len}"
          + (f", shared attention every {cfg.attn_every} ({cfg.num_heads}"
             f"/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff})"
             if cfg.family == "hybrid" else "")
          + f"; {n_params / 1e9:.3f}B params bf16", flush=True)

    inputs = {"tokens": tokens[:, :n_tokens]}
    model.prefill(params, inputs)                       # warm-up
    (logits, pre), pre_ms = cuda_timed(lambda: model.prefill(params, inputs))
    cache = _decode_cache(model, pre, n_tokens, device, torch.bfloat16)
    tok, step_ms, diff = tokens[:, n_tokens], [], None
    for i in range(new):
        (lg, cache), ms = cuda_timed(
            lambda: model.decode_step(params, cache, tok, n_tokens + i))
        step_ms.append(ms)
        check(bool(torch.isfinite(lg.float()).all()),
              f"path G {arch}: decode step {i} not finite")
        if i == 0:
            ref, _ = model.prefill(params, {"tokens": tokens})
            diff = float((lg.float() - ref.float()).abs().max())
            del ref
        tok = lg.float()[:, :cfg.vocab_size].argmax(-1)
    del pre, cache
    print(f"[path G] {arch} bf16: prefill {n_tokens} tokens {pre_ms:.3f} ms "
          f"(CUDA events, second call); decode {new} steps "
          f"{', '.join(f'{t:.3f}' for t in step_ms)} ms, median "
          f"{statistics.median(step_ms):.3f} ms a step; |decode - "
          f"prefill({n_tokens + 1})| {diff:.6f} (printed, not limited)",
          flush=True)
    p32 = _tree(lambda t: t.float(), params)
    del params
    d32 = decode_vs_prefill(model, p32, tokens, check_tokens, device)
    print(f"[path G] {arch} fp32 copy: |decode - prefill({check_tokens + 1})|"
          f" {d32:.6f} (limit 0.15)", flush=True)
    check(d32 < 0.15, f"path G {arch}: fp32 decode/prefill mismatch {d32}")
    del p32
    free_card()


# ----------------------------------------------------------------------------
# paths H, T1 and T2: Whisper, training, checkpoints and fault restart
# ----------------------------------------------------------------------------


def _max_diff(a, b):
    """Largest |a - b| over two same-shaped tensors, in fp32, a slice at a
    time (no full-size fp32 temporaries of a multi-GB leaf)."""
    worst = 0.0
    n = 1 << 26
    for x, y in zip(a.reshape(-1).split(n), b.reshape(-1).split(n)):
        worst = max(worst, float((x.float() - y.float()).abs().max()))
    return worst


def path_h(cfg, device, *, batch=4, n_frames=1500, new=32, check_steps=16,
           seed=0):
    """whisper-tiny at full width and depth, random bf16 weights: prefill
    (encode + cross-K/V) of `batch` x `n_frames` frames and `new` greedy
    decode steps, timed with CUDA events; then `check_steps`
    teacher-forced decode steps against decode_train's logits at the same
    positions, on an fp32 copy of the weights (limit 0.15) and in bf16
    (printed)."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models import encdec as E
    from repro_torch.models import transformer as T
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed),
                        device=device)
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.normal(size=(
        batch, n_frames, cfg.d_model)).astype(np.float32) * 0.1).to(
            torch.bfloat16).to(device)
    print(f"[path H] {cfg.name} (encdec): {cfg.num_layers} encoder + "
          f"{cfg.dec_layers} decoder layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size} (padded {cfg.padded_vocab}), dec_len "
          f"{cfg.dec_len}; {n_params / 1e6:.3f}M params bf16; batch {batch} "
          f"x {n_frames} frames", flush=True)
    inputs = {"frames": frames}
    model.prefill(params, inputs)                       # warm-up
    pf, pre_ms = cuda_timed(lambda: model.prefill(params, inputs))
    check(tuple(pf["cross_k"].shape) == (cfg.dec_layers, batch, n_frames,
                                         cfg.num_kv_heads,
                                         cfg.resolved_head_dim),
          f"path H: cross-K/V of shape {tuple(pf['cross_k'].shape)}")
    cache = dict(model.init_cache(batch, n_frames, device=device), **pf)
    tok = torch.zeros(batch, dtype=torch.int64, device=device)
    step_ms = []
    for i in range(new):
        (lg, cache), ms = cuda_timed(
            lambda: model.decode_step(params, cache, tok, i))
        step_ms.append(ms)
        check(bool(torch.isfinite(lg.float()).all()),
              f"path H: decode step {i} not finite")
        tok = lg.float()[:, :cfg.vocab_size].argmax(-1)
    print(f"[path H] bf16: prefill {pre_ms:.3f} ms (CUDA events, second "
          f"call); {new} greedy decode steps, median "
          f"{statistics.median(step_ms):.3f} ms a step (min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f})", flush=True)
    del cache, pf

    dec = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                       size=(batch, check_steps)),
                          device=device)

    def decode_vs_teacher_forced(p, x, dtype):
        ref = T.unembed(cfg, p, E.decode_train(cfg, p, E.encode(cfg, p, x),
                                               dec)).float()
        c = dict(E.init_cache(cfg, batch, n_frames, device=device,
                              dtype=dtype),
                 **model.prefill(p, {"frames": x}))
        worst = 0.0
        for i in range(check_steps):
            lg, c = model.decode_step(p, c, dec[:, i], i)
            worst = max(worst, float((lg.float() - ref[:, i]).abs().max()))
        return worst

    d16 = decode_vs_teacher_forced(params, frames, torch.bfloat16)
    p32 = _tree(lambda t: t.float(), params)
    del params
    d32 = decode_vs_teacher_forced(p32, frames.float(), torch.float32)
    print(f"[path H] |decode - decode_train| over {check_steps} "
          f"teacher-forced steps: fp32 copy {d32:.6f} (limit 0.15), bf16 "
          f"{d16:.6f} (printed, not limited)", flush=True)
    check(d32 < 0.15, f"path H: fp32 decode/decode_train mismatch {d32}")
    del p32
    free_card()


def _t1_probes(params):
    """Slices of two leaves, kept to compare paths T1 and S."""
    emb, w_up = params["emb"], params["blocks"]["mlp"]["w_up"]
    if hasattr(emb, "to_local"):            # a DTensor (path S)
        emb, w_up = emb.to_local(), w_up.to_local()
    return {"emb": emb[:64].clone(), "w_up": w_up[-1, :64].clone()}


def path_t1(cfg, device, *, batch=2, seq=1024, steps=6, seed=0, keep=3):
    """Training at full width and depth (qwen2.5-3b): bf16 params, fp32
    moments, remat "full", build_train_step over data_batch; `steps`
    steps timed with CUDA events; then one step with microbatches=2
    against microbatches=1 on the first batch from the same params (the
    bounds of tests/test_training.py). Returns what path S is held to:
    the first `keep` steps' losses and grad norms, the param probes after
    them, the steady ms a step and the peak memory."""
    import torch
    from repro_torch.configs import TrainConfig
    from repro_torch.models import build_model
    from repro_torch.training.trainer import build_train_step, data_batch
    model = build_model(cfg)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1,
                       total_steps=steps, seed=seed)
    step_fn, opt = build_train_step(model, tcfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=device).manual_seed(seed),
                        device=device)
    n = sum(t.numel() for t in _leaves(params))
    probe = {"emb": params["emb"][:64].clone(),
             "w_up": params["blocks"]["mlp"]["w_up"][-1, :64].clone()}
    state = opt.init(params)
    print(f"[path T1] {cfg.name} ({cfg.family}): {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; {n / 1e9:.4f}B params "
          f"bf16, moments {cfg.moment_dtype}, remat {cfg.remat}; batch "
          f"{batch} x seq {seq}, lr {tcfg.learning_rate} (warmup "
          f"{tcfg.warmup_steps}); memory after init "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB", flush=True)
    step_ms, hist = [], []
    for step in range(steps):
        b = data_batch(cfg, tcfg, step, batch, seq, device=device)
        (params, state, m), ms = cuda_timed(
            lambda: step_fn(params, state, b))
        step_ms.append(ms)
        loss, gn, lr = (float(m["loss"]), float(m["grad_norm"]),
                        float(m["lr"]))
        hist.append((loss, gn))
        if step == keep - 1:
            kept = _t1_probes(params)
        print(f"[path T1] step {step}: loss {loss:.6f}, grad norm {gn:.6f}, "
              f"lr {lr:.3e}, {ms:.3f} ms (CUDA events)", flush=True)
        check(math.isfinite(loss) and math.isfinite(gn),
              f"path T1: step {step} loss {loss}, grad norm {gn}")
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(step_ms[1:])
    tokens = batch * seq
    flops = 6 * n * tokens / (steady / 1e3)
    print(f"[path T1] steps 1-{steps - 1} median {steady:.3f} ms a step "
          f"(step 0 {step_ms[0]:.3f}); {tokens / (steady / 1e3):.1f} "
          f"tokens/s; model FLOP/s (6 N tokens / step time) "
          f"{flops / 1e12:.3f} T = {flops / BF16_FLOPS:.4f} of "
          f"{BF16_FLOPS / 1e12:.0f} TFLOP/s bf16; peak memory "
          f"{peak / 1e9:.3f} GB (max_memory_allocated)", flush=True)
    changed = {k: _max_diff(v, params["emb"][:64] if k == "emb" else
                            params["blocks"]["mlp"]["w_up"][-1, :64])
               for k, v in probe.items()}
    check(all(d > 0 for d in changed.values()),
          f"path T1: params did not change ({changed})")
    del state, probe
    free_card()

    # grad accumulation: one step each from the same params and batch
    torch.cuda.reset_peak_memory_stats()
    b0 = data_batch(cfg, tcfg, 0, batch, seq, device=device)
    out = {}
    for mb in (1, 2):
        fn, o = build_train_step(model, dataclasses.replace(
            tcfg, microbatches=mb))
        p = _tree(torch.clone, params) if mb == 1 else params
        st = o.init(p)
        (p, st, m), ms = cuda_timed(lambda: fn(p, st, b0))
        del st
        free_card()
        out[mb] = (p, float(m["loss"]), ms)
    dloss = abs(out[1][1] - out[2][1])
    dparam = max(_max_diff(a, c) for a, c in zip(_leaves(out[1][0]),
                                                 _leaves(out[2][0])))
    print(f"[path T1] microbatches 2 vs 1 on the first batch: loss "
          f"{out[2][1]:.6f} vs {out[1][1]:.6f} (|diff| {dloss:.6f}, limit "
          f"5e-3), params max |diff| {dparam:.6f} (limit 2e-2); "
          f"{out[2][2]:.3f} vs {out[1][2]:.3f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
    check(dloss < 5e-3, f"path T1: grad accumulation loss gap {dloss}")
    check(dparam < 2e-2, f"path T1: grad accumulation params gap {dparam}")
    del out, params, p
    free_card()
    return {"hist": hist[:keep], "probes": kept, "ms": steady,
            "peak": peak, "tcfg": tcfg}


def path_s(cfg, device, t1, *, batch=2, seq=1024, seed=0):
    """The sharded train step on the card: a one-rank NCCL process group
    (a local store), a (1, 1) ("data", "model") mesh, make_rules, and
    qwen2.5-3b at full width and depth through jit_train_step from T1's
    seed, TrainConfig and data_batch, for as many steps as T1 kept. Its
    losses, grad norms and param probes against T1's (a one-device mesh
    runs the same kernels: limit 1e-6); ms a step (CUDA events) and peak
    memory beside T1's. Then compressed_psum over one layer's grads on
    NCCL at world size 1: the mean equals the grads to int8 rounding and
    the residual carries. The group is destroyed at the end."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import make_rules, mesh_shape
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.training.compression import (compressed_psum,
                                                  init_error_state)
    from repro_torch.training.trainer import (partitioned,
                                              build_train_step, data_batch,
                                              jit_train_step, shard_tree,
                                              value_and_grad)
    tcfg, steps = t1["tcfg"], len(t1["hist"])
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        check(dist.get_backend() == "nccl",
              f"path S: backend {dist.get_backend()}, not nccl")
        mesh = make_local_mesh((1, 1), device="cuda")
        rules = make_rules(cfg, mesh)
        model = build_model(cfg)
        step_fn, opt = jit_train_step(
            model, tcfg, rules,
            model.input_pspecs(ShapeConfig("s", "train", seq, batch), rules))
        torch.cuda.reset_peak_memory_stats()
        params = shard_tree(
            model.init(torch.Generator(device=device).manual_seed(seed),
                       device=device), model.param_shardings(rules))
        state = opt.init(params)
        print(f"[path S] {cfg.name}: jit_train_step on a one-rank "
              f"{dist.get_backend()} group, mesh {mesh_shape(mesh)}, "
              f"{type(params['emb']).__name__} params; {steps} steps of "
              f"T1's batches ({batch} x {seq} tokens)", flush=True)
        step_ms, dl, dg = [], 0.0, 0.0
        for step in range(steps):
            b = data_batch(cfg, tcfg, step, batch, seq, device=device)
            (params, state, m), ms = cuda_timed(
                lambda: step_fn(params, state, b))
            step_ms.append(ms)
            loss, gn = float(m["loss"]), float(m["grad_norm"])
            tl, tg = t1["hist"][step]
            dl, dg = max(dl, abs(loss - tl)), max(dg, abs(gn - tg))
            print(f"[path S] step {step}: loss {loss:.6f} (T1 {tl:.6f}), "
                  f"grad norm {gn:.6f} (T1 {tg:.6f}), {ms:.3f} ms "
                  "(CUDA events)", flush=True)
        peak = torch.cuda.max_memory_allocated()
        probes = _t1_probes(params)
        dp = max(_max_diff(probes[k], t1["probes"][k]) for k in probes)
        steady = statistics.median(step_ms[1:])
        print(f"[path S] against T1: losses max |diff| {dl:.3e}, grad norms "
              f"max |diff| {dg:.3e} (limit 1e-6 each), param probes max "
              f"|diff| {dp:.3e}; steps 1-{steps - 1} median {steady:.3f} ms "
              f"a step (step 0 {step_ms[0]:.3f}) vs T1's {t1['ms']:.3f} ms "
              f"({steady / t1['ms']:.3f}x); peak memory {peak / 1e9:.3f} GB "
              f"vs T1's {t1['peak'] / 1e9:.3f} GB", flush=True)
        check(dl <= 1e-6 and dg <= 1e-6,
              f"path S: losses {dl}, grad norms {dg} off T1's")

        # where the extra host time goes: the ops one step dispatches,
        # through DTensor and, on the same local tensors, plain
        b = data_batch(cfg, tcfg, steps, batch, seq, device=device)
        _, n_dt = count_ops(lambda: step_fn(params, state, b))
        local = _tree(lambda t: t.to_local(), params)
        plain_fn, plain_opt = build_train_step(model, tcfg)
        lstate = type(state)(_tree(lambda t: t.to_local(), state.m),
                             _tree(lambda t: t.to_local(), state.v),
                             state.count)
        _, n_plain = count_ops(lambda: plain_fn(local, lstate, b))
        del local, lstate
        extra = (steady - t1["ms"]) / n_plain * 1e3
        print(f"[path S] ops a step: {n_dt} through DTensor, {n_plain} "
              f"plain on the same local tensors; (S - T1) ms a step / plain "
              f"ops = {extra:.1f} us of DTensor host work an op", flush=True)

        # int8 error-feedback all-reduce over one layer's grads, on NCCL
        b = data_batch(cfg, tcfg, steps, batch, seq, device=device)
        with partitioned(rules):
            _, grads = value_and_grad(model.loss, params, b)
        g = {k: v.to_local()[0].float() for k, v in
             grads["blocks"]["mlp"].items()}
        del grads
        err = init_error_state(g)
        worst, carried, sent = 0.0, 0.0, {k: 0.0 for k in g}
        for _ in range(2):
            gf = {k: g[k] + err[k] for k in g}
            avg, new = compressed_psum(g, err)
            for k in g:
                scale = (gf[k].abs().max() + 1e-12) / 127.0
                worst = max(worst, float((avg[k] - gf[k]).abs().max()
                                         / scale))
                sent[k] = sent[k] + avg[k]
            err = new
        for k in g:     # what was sent is the grads less the residual
            carried = max(carried, float((sent[k] - (2 * g[k] - err[k]))
                                         .abs().max()))
        nz = sum(float(e.abs().sum()) for e in err.values())
        shapes = ", ".join(f"{k} {tuple(v.shape)}" for k, v in g.items())
        print(f"[path S] compressed_psum (nccl, world 1) over layer 0's MLP "
              f"grads ({shapes}): "
              f"mean vs grads max {worst:.3f} quantization steps (limit "
              f"0.5), two steps' sum vs 2 g - residual max |diff| "
              f"{carried:.3e}, residual |sum| {nz:.3e}", flush=True)
        check(worst <= 0.5 + 1e-3, f"path S: int8 mean off by {worst} steps")
        check(carried <= 1e-6 and nz > 0,
              f"path S: the residual did not carry ({carried}, {nz})")
    finally:
        params = state = g = err = avg = new = None
        free_card()
        dist.destroy_process_group()


def path_t2(cfg, device, *, batch=4, n_frames=1500, steps=12, every=4,
            fault_step=7):
    """Checkpoints and fault restart at full width (whisper-tiny):
    train_loop uninterrupted, and again with a failure injected at
    `fault_step` and a restart from the last commit; the final params
    and moments bit-equal. Runs under torch.use_deterministic_algorithms
    (the embedding gather's and the loss gather's backward accumulate
    with atomics otherwise)."""
    import tempfile

    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import TrainConfig
    from repro_torch.models import build_model
    from repro_torch.training.trainer import FaultInjector, train_loop
    from repro_torch.tree import leaves
    model = build_model(cfg)
    tcfg = TrainConfig(total_steps=steps, warmup_steps=2,
                       checkpoint_every=every)
    kw = dict(batch=batch, seq=n_frames, steps=steps, log_every=1,
              device=device)
    print(f"[path T2] {cfg.name}: train_loop, batch {batch} x {n_frames} "
          f"frames (+ {cfg.dec_len + 1} decoder tokens), {steps} steps, "
          f"checkpoint every {every}; a failure injected at step "
          f"{fault_step}; deterministic algorithms on", flush=True)
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as d:
            cm1 = CheckpointManager(os.path.join(d, "a"))
            t0 = time.perf_counter()
            r1 = train_loop(model, tcfg, ckpt_manager=cm1, **kw)
            wall1 = time.perf_counter() - t0
            cm2 = CheckpointManager(os.path.join(d, "b"))
            fault = FaultInjector((fault_step,))
            try:
                train_loop(model, tcfg, ckpt_manager=cm2, fault=fault, **kw)
            except RuntimeError as e:
                print(f"[path T2] {e}; commits {cm2.all_steps()}",
                      flush=True)
            check(fault.fired == {fault_step},
                  "path T2: the injected failure did not fire")
            resumed = cm2.all_steps()[-1]
            t0 = time.perf_counter()
            r2 = train_loop(model, tcfg, ckpt_manager=cm2, fault=fault, **kw)
            wall2 = time.perf_counter() - t0
            check(r2["history"][0][0] == resumed,
                  f"path T2: resumed at {r2['history'][0][0]}, not {resumed}")
            a = leaves({"params": r1["params"], "opt": r1["opt"]})
            b = leaves({"params": r2["params"], "opt": r2["opt"]})
            same = len(a) == len(b) and all(torch.equal(x, y)
                                            for x, y in zip(a, b))
            nbytes = sum(x.numel() * x.element_size() for x in a)
            state = {"params": r2["params"], "opt": r2["opt"]}
            t0 = time.perf_counter()
            cm2.save(state, steps + 1, block=True)
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            cm2.restore(steps + 1, like=state, device=device)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    losses = [f"{l:.4f}" for _, l in r1["history"]]
    print(f"[path T2] uninterrupted: {steps} steps in {wall1:.3f} s, losses "
          f"{', '.join(losses)}; restarted run: resumed from step "
          f"{resumed}, {steps - resumed} steps in {wall2:.3f} s; final "
          f"params and moments ({len(a)} leaves) bit-equal: {same}; one "
          f"checkpoint ({nbytes / 1e6:.1f} MB) written in {write_s:.3f} s, "
          f"restored onto the card in {restore_s:.3f} s (host clock)",
          flush=True)
    check(same, "path T2: the restarted run's state differs")
    del r1, r2, state, a, b
    free_card()


# ----------------------------------------------------------------------------
# paths P and R: prefill and decode over DTensors; the dry run
# ----------------------------------------------------------------------------


def _serve(model, params, tokens, steps, rules_pre, rules_dec):
    """A prefill of `tokens` and len(steps) decode steps fed the tokens
    `steps` (plain tensors, or DTensors under the rules: the prefill's
    outputs laid out by prefill_out_axes, the decode cache by
    cache_axes). Returns (logits list, prefill cache, final cache, prefill
    ms, decode ms list, ops a prefill, ops a decode step)."""
    import torch
    from repro_torch.models.api import lay_out
    from repro_torch.training.trainer import partitioned
    n = tokens.shape[1]
    pos0 = 0 if model.cfg.family == "encdec" else n

    def tok(t):
        return rules_dec.distribute(t, ("batch",)) if rules_dec else t

    def prefill():
        with torch.no_grad(), partitioned(rules_pre):
            x = {"tokens": rules_pre.distribute(tokens, ("batch", None))
                 if rules_pre else tokens}
            out = model.prefill(params, x)
            return lay_out(out, model.prefill_out_axes(), rules_pre) \
                if rules_pre else out

    def decode(cache, t, pos):
        with torch.no_grad(), partitioned(rules_dec):
            out = model.decode_step(params, cache, tok(t), pos)
            return lay_out(out, (("batch", "act_vocab"),
                                 model.cache_axes()), rules_dec) \
                if rules_dec else out

    prefill()                                           # warm-up
    (logits, pre), pre_ms = cuda_timed(prefill)
    _, pre_ops = count_ops(prefill)
    with torch.no_grad(), partitioned(rules_dec):
        cache = model.decode_cache(_tree(lambda t: t.clone(), pre),
                                   rules_dec)
        if rules_dec:
            cache = lay_out(cache, model.cache_axes(), rules_dec)
    out, step_ms = [logits], []
    for i, t in enumerate(steps):
        (lg, cache), ms = cuda_timed(lambda: decode(cache, t, pos0 + i))
        out.append(lg)
        step_ms.append(ms)
    spare = _tree(lambda t: t.clone(), cache)
    _, dec_ops = count_ops(lambda: decode(spare, steps[-1],
                                          pos0 + len(steps)))
    return out, pre, cache, pre_ms, step_ms, pre_ops, dec_ops


def path_p(cfgs, device, *, n_tokens=2048, new=8, seed=0):
    """Prefill and decode over DTensors on the card: a one-rank NCCL group
    (a local store), a (1, 1) ("data", "model") mesh and the dry run's
    rules (make_rules for prefill, weight-stationary for decode). Each
    config at full width and depth, random bf16 weights from a seed: an
    n_tokens prefill and `new` decode steps over DTensors beside the plain
    port on the same weights and tokens (seeded decode tokens): every
    logits tensor and the prefill and final caches
    within 1e-6; ms (CUDA events) and ops a call, through DTensor and
    plain. The group is destroyed at the end."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.distributed.spmd import is_dtensor
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.training.trainer import shard_tree
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        check(dist.get_backend() == "nccl",
              f"path P: backend {dist.get_backend()}, not nccl")
        mesh = make_local_mesh((1, 1), device="cuda")
        for cfg in cfgs:
            model = build_model(cfg)
            params = model.init(torch.Generator(device=device)
                                .manual_seed(seed), device=device)
            rng = np.random.default_rng(seed)
            tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                  size=(1, n_tokens)),
                                     device=device)
            toks = [torch.as_tensor(t, device=device) for t in
                    rng.integers(0, cfg.vocab_size, size=(new, 1))]
            plain = _serve(model, params, tokens, toks, None, None)
            rp = make_rules(cfg, mesh)
            rd = make_rules(cfg, mesh, weight_stationary=True)
            sharded = _serve(model, shard_tree(params,
                                               model.param_shardings(rp)),
                             tokens, toks, rp, rd)
            check(all(is_dtensor(t) for t in _leaves(sharded[2])),
                  f"path P {cfg.name}: the sharded cache is not DTensors")
            full = lambda t: t.full_tensor() if is_dtensor(t) else t
            d_log = max(_max_diff(full(a), b)
                        for a, b in zip(sharded[0], plain[0]))
            d_pre = max(_max_diff(full(a), b) for a, b in
                        zip(_leaves(sharded[1]), _leaves(plain[1])))
            d_fin = max(_max_diff(full(a), b) for a, b in
                        zip(_leaves(sharded[2]), _leaves(plain[2])))
            fin = all(bool(torch.isfinite(t.float()).all())
                      for t in plain[0])
            print(f"[path P] {cfg.name} ({cfg.family}), {cfg.num_layers} "
                  f"layers, d_model {cfg.d_model}: prefill {n_tokens} "
                  f"tokens {sharded[3]:.3f} ms over DTensors vs "
                  f"{plain[3]:.3f} ms plain (CUDA events, second call); "
                  f"decode step 0 {sharded[4][0]:.3f} vs {plain[4][0]:.3f} "
                  f"ms, steps 1-{new - 1} median "
                  f"{statistics.median(sharded[4][1:]):.3f} vs "
                  f"{statistics.median(plain[4][1:]):.3f} ms; ops a "
                  f"prefill {sharded[5]} DTensor vs {plain[5]} plain, a "
                  f"decode step {sharded[6]} vs {plain[6]}", flush=True)
            print(f"[path P] {cfg.name}: max |DTensor - plain| logits "
                  f"{d_log:.3e} ({len(plain[0])} calls), prefill cache "
                  f"{d_pre:.3e}, final cache {d_fin:.3e} (limit 1e-6 each)",
                  flush=True)
            check(fin, f"path P {cfg.name}: plain logits not finite")
            check(max(d_log, d_pre, d_fin) <= 1e-6,
                  f"path P {cfg.name}: DTensor run off the plain one "
                  f"({d_log}, {d_pre}, {d_fin})")
            del params, plain, sharded
            free_card()
    finally:
        free_card()
        dist.destroy_process_group()


def path_r(cells=(("mamba2-130m", "decode_32k"),
                  ("granite-moe-3b-a800m", "decode_32k")), *, timeout=600):
    """The dry run on a CUDA-typed mesh: a subprocess starts a fake
    256-rank process group and traces each (arch, shape) cell on the
    16x16 production mesh of fake CUDA tensors (launch/dryrun.py); its
    exit code decides. Prints each record's status, seconds, peak bytes
    per rank, flops per rank, collectives by kind and roofline terms
    (the H100 model's; estimates, not measurements)."""
    import tempfile
    with tempfile.TemporaryDirectory() as out:
        env = dict(os.environ, PYTHONPATH=SRC)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", ",".join(a for a, _ in cells),
               "--shape", ",".join(sorted({s for _, s in cells})),
               "--mesh", "single", "--device", "cuda", "--out", out]
        t0 = time.perf_counter()
        try:
            res = subprocess.run(cmd, env=env, capture_output=True,
                                 text=True, timeout=timeout)
        except subprocess.TimeoutExpired:
            raise SmokeError(f"path R: the dry run took over {timeout} s")
        wall = time.perf_counter() - t0
        recs = []
        for arch, shape in cells:
            path = os.path.join(out, "pod16x16", f"{arch}__{shape}.json")
            if os.path.exists(path):
                with open(path) as f:
                    recs.append(json.load(f))
    print(f"[path R] dry run on a fake 256-rank group, CUDA-typed 16x16 "
          f"mesh: exit {res.returncode}, {wall:.1f} s wall", flush=True)
    for rec in recs:
        if rec["status"] != "OK":
            print(f"[path R] {rec['arch']} x {rec['shape']}: "
                  f"{rec['status']} {rec.get('error', '')}\n"
                  f"{rec.get('traceback', '')[-2500:]}", flush=True)
            continue
        m, rl = rec["memory"], rec["roofline"]
        kinds = {k: v["count"] for k, v in
                 rec["collectives"]["by_kind"].items()}
        print(f"[path R] {rec['arch']} x {rec['shape']} ({rec['device']}):"
              f" OK, trace {rec['trace_s']} s, {rec['local_ops']} local "
              f"ops; peak {m['peak_est_bytes'] / 1e9:.3f} GB a rank of "
              f"80 GB; flops/rank {rec['cost']['flops_per_dev']:.4e}, "
              f"bytes/rank {rec['cost']['bytes_per_dev']:.4e}; collectives "
              f"{kinds}, wire {rec['collectives']['wire_bytes']:.4e} B; "
              f"roofline compute {rl['compute_s']:.3e} s, memory "
              f"{rl['memory_s']:.3e} s, collective {rl['collective_s']:.3e}"
              f" s, {rl['dominant']}-bound (estimates)", flush=True)
    if res.returncode:
        raise SmokeError(f"path R: dry run exit {res.returncode}: "
                         f"{res.stderr[-3000:]}")
    check(len(recs) == len(cells) and all(r["status"] == "OK" and
                                          r["device"] == "cuda"
                                          for r in recs),
          f"path R: cells {[(r['arch'], r['status']) for r in recs]}")


HARNESS_BENCHES = ("fig8", "fig4", "quality")


def path_harness(*, benches=HARNESS_BENCHES, device="cuda", timeout=600):
    """The port's benchmark harness on the card, in a subprocess, as a
    user runs it: python -m benchmarks_torch.run --quick --only <benches>
    --device cuda. Its exit code decides; prints each bench's wall time
    (host clock, the harness's summary) and checks that every cachegen
    request of the quality bench assembled its streamed chunks in one
    kv_dequant launch (its saved kv_dequant_launches). Returns the
    quality bench's kv_dequant launches."""
    env = dict(os.environ, PYTHONPATH=SRC)
    cmd = [sys.executable, "-m", "benchmarks_torch.run", "--quick",
           "--only", ",".join(benches), "--device", device]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                             text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        raise SmokeError(f"path harness: over {timeout} s")
    wall = time.perf_counter() - t0
    summary = res.stdout[res.stdout.rfind("=== benchmark summary"):]
    for line in summary.splitlines():
        print(f"[path harness] {line.strip()}", flush=True)
    print(f"[path harness] {' '.join(cmd[1:])}: exit {res.returncode}, "
          f"{wall:.1f} s wall (host clock, process start included)",
          flush=True)
    if res.returncode:
        raise SmokeError(f"path harness: exit {res.returncode}: "
                         f"{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
    with open(os.path.join(ROOT, "results", "benchmarks_torch", "quick",
                           "quality_validation.json")) as f:
        quality = json.load(f)
    launches = quality["kv_dequant_launches"]
    print(f"[path harness] quality on {quality['_device']}: kv_dequant "
          f"launches a cachegen request {launches}; rows "
          f"{quality['rows']}", flush=True)
    check(launches and all(n == 1 for n in launches),
          f"path harness: quality's cachegen requests launched kv_dequant "
          f"{launches} times, not once each")
    return sum(launches)


def _start_example(label, cmd, tmp):
    """Starts one example of examples_torch/ in a subprocess from the
    checkout's root, its temporary files (TMPDIR) and its output under
    `tmp`: (the process, its start on the host's wall clock)."""
    env = dict(os.environ, PYTHONPATH=SRC, TMPDIR=tmp)
    t0 = time.time()
    with open(os.path.join(tmp, f"{label}.out"), "w") as out, \
            open(os.path.join(tmp, f"{label}.err"), "w") as err:
        proc = subprocess.Popen([sys.executable, *cmd], env=env, cwd=ROOT,
                                stdout=out, stderr=err, text=True)
    return proc, t0


def _finish_example(label, cmd, started, tmp, card, timeout):
    """Waits up to `timeout` s for an example started by _start_example
    and prints its wall time; its stdout. Its exit code decides. The wall
    time ends at the last write to its output files, so an example that
    ended while this process was busy is not charged the wait (its stdout,
    a file, is flushed when it exits)."""
    proc, t0 = started
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        raise SmokeError(f"path X {label}: over {timeout} s")
    files = [os.path.join(tmp, f"{label}.{s}") for s in ("out", "err")]
    wall = max(map(os.path.getmtime, files)) - t0
    with open(files[0]) as f:
        out = f.read()
    with open(files[1]) as f:
        err = f.read()
    print(f"[path X] {label}: {' '.join(cmd)}: exit {proc.returncode}, "
          f"{wall:.1f} s wall (host clock, process start to its last output; "
          f"{card})", flush=True)
    if proc.returncode:
        raise SmokeError(f"path X {label}: exit {proc.returncode}: "
                         f"{out[-2000:]}\n{err[-3000:]}")
    return out


def path_x(card, *, device="cuda", train_steps=200, fail_at=120):
    """The port's examples (examples_torch/) on the card, as a user runs
    them. serve_fleet and serve_under_volatility, host simulations, start
    through the runner at the path's start and run beside quickstart and
    elastic_rescale. quickstart runs in this process under
    repro_torch.device.named: its sparkv and cachegen requests dequantize
    their streamed chunks in exactly one kv_dequant launch each,
    local_prefill in none, at fidelity 1.00. elastic_rescale runs on a
    one-rank NCCL group. train_lm runs last and alone, so its ms a step
    shares the card and the host with no other example: its own size
    (the ~100M model, `train_steps` steps, a failure injected at
    `fail_at` and a restart from the last commit; its own assertion that
    the loss improved). Each subprocess's exit code decides, and its
    TMPDIR is a temporary directory of this run. The card's name and
    power limit (`card`) stand beside every number. Returns quickstart's
    kv_dequant launches."""
    import contextlib
    import io
    import re
    import tempfile

    import examples_torch.quickstart as Q
    from repro_torch.device import named
    from repro_torch.kernels.kv_dequant import kernel as K
    from repro_torch.serving import engine as E

    t_path = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        serving = {name: ["-m", "examples_torch.run", name, "--device",
                          device]
                   for name in ("serve_fleet", "serve_under_volatility")}
        procs = {}
        try:
            for name, cmd in serving.items():
                procs[name] = _start_example(name, cmd, tmp)

            launched = {}
            generate = E.SparKVServer.generate

            def counted(self, cid, prompt, max_new=8, *, policy="sparkv",
                        **kw):
                K.reset_launches()
                r = generate(self, cid, prompt, max_new, policy=policy, **kw)
                launched[policy] = dict(K.LAUNCHES)
                return r

            buf = io.StringIO()
            E.SparKVServer.generate = counted
            try:
                t0 = time.perf_counter()
                with named(device), contextlib.redirect_stdout(buf):
                    results = Q.main([])
                wall = time.perf_counter() - t0
            finally:
                E.SparKVServer.generate = generate
            for line in buf.getvalue().splitlines():
                print(f"[path X] quickstart: {line}")
            print(f"[path X] quickstart: {wall:.1f} s wall (host clock; "
                  f"{card}); dequant launches a request {launched}",
                  flush=True)
            for policy, r in results.items():
                want = 1 if policy in ("sparkv", "cachegen") else 0
                check(launched[policy] == {"kv_dequant": want,
                                           "kv_dequant_mixed": 0},
                      f"path X quickstart {policy}: dequant launches "
                      f"{launched[policy]}, not {want} kv_dequant")
                check((r.n_streamed > 0) == bool(want),
                      f"path X quickstart {policy}: {r.n_streamed} streamed "
                      "chunks")
            check(results["local_prefill"].top1_agreement == 1.0,
                  f"path X quickstart local_prefill: fidelity "
                  f"{results['local_prefill'].top1_agreement}, not 1.00")

            elastic = ["examples_torch/elastic_rescale.py", "--device",
                       device]
            procs["elastic_rescale"] = _start_example("elastic_rescale",
                                                      elastic, tmp)
            out = _finish_example("elastic_rescale", elastic,
                                  procs["elastic_rescale"], tmp, card, 300)
            for line in out.splitlines():
                print(f"[path X] elastic_rescale: {line}")
            check("1 devices visible (nccl ranks on cuda)" in out,
                  f"path X elastic_rescale: not a one-rank NCCL group: "
                  f"{out[-1000:]}")
            for name, cmd in serving.items():
                out = _finish_example(name, cmd, procs[name], tmp, card, 400)
                for line in out.splitlines()[-3:]:
                    print(f"[path X] {name}: {line}")

            train = ["examples_torch/train_lm.py", "--device", device,
                     "--steps", str(train_steps), "--fail-at", str(fail_at)]
            procs["train_lm"] = _start_example("train_lm", train, tmp)
            out = _finish_example("train_lm", train, procs["train_lm"], tmp,
                                  card, 600)
        finally:
            for proc, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    restarts = re.search(r"(\d+) steps, (\d+) restarts", out)
    run = re.search(r"last run: steps (\d+)-\d+, ([\d.]+) ms a step", out)
    loss = re.search(r"loss ([\d.]+) -> ([\d.]+)  \[improved\]", out)
    check(restarts and run and loss, f"path X train_lm: output {out[-2000:]}")
    check(int(restarts.group(2)) == 1,
          f"path X train_lm: {restarts.group(2)} restarts, not 1")
    print(f"[path X] train_lm: {restarts.group(1)} steps, "
          f"{restarts.group(2)} restart (failure at step {fail_at}), resumed "
          f"at step {run.group(1)}; loss {loss.group(1)} -> "
          f"{loss.group(2)}; {run.group(2)} ms a step over the resumed run, "
          f"alone (host clock, checkpoints included; {card})", flush=True)
    print(f"[path X] {time.perf_counter() - t_path:.1f} s wall (host clock; "
          f"{card})", flush=True)
    return sum(n["kv_dequant"] for n in launched.values())


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree



# ----------------------------------------------------------------------------


def fail(msg, code=1):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main():
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail("src/repro_torch not found beside chip_smoke.py; run it from "
             "a checkout of the repository", 2)
    sys.path.insert(0, SRC)
    # path T2 runs under torch.use_deterministic_algorithms, which needs a
    # fixed cuBLAS workspace, set before cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    for name in SOURCES:
        for line in ptxas_summary(_build.ptxas_report(name)):
            print(f"[ptxas] {line}")

    try:
        print("[kernels] against their plain versions on the card")
        perf = kernel_phase(device)
        att_err = attention_phase(device)

        from repro_torch.configs import SparKVConfig, get_config
        from repro_torch.kernels.kv_dequant import kernel as K
        cfg = get_config("sparkv-qwen3-4b")
        launches = {name: 0 for name in KERNELS}

        # path A: full width and depth, uniform 5-bit chunks (its cachegen
        # request, nearly all host Huffman decode, is left out to keep the
        # run's time: phase 2 times a cachegen request's launch)
        spcfg = SparKVConfig(chunk_tokens=1024)
        kept = {}
        for policy, res, launched, widths in serve_path(
                "path A", cfg, spcfg, 2048, ("sparkv", "local_prefill"),
                device, keep=kept):
            want = 1 if res.n_streamed else 0
            check(launched == {"kv_dequant": want, "kv_dequant_mixed": 0},
                  f"{policy}: dequant launches {launched}, not {want} "
                  f"kv_dequant for {res.n_streamed} streamed chunks")
            for k in launched:
                launches[k] += launched[k]
        check(launches["kv_dequant"] == 1,
              f"path A launched kv_dequant {launches['kv_dequant']} times, "
              "not 1")
        dequant_routes(kept["server"], kept.pop("context"), device)
        K.reset_launches()

        # path B: same width, 4 layers, per-chunk widths
        cfg_b = dataclasses.replace(cfg, num_layers=4)
        spcfg_b = SparKVConfig(chunk_tokens=1024,
                               alloc_schedule="attention")
        for policy, res, launched, widths in serve_path(
                "path B", cfg_b, spcfg_b, 2048, ("cachegen",), device):
            print(f"[path B] streamed chunk widths {sorted(widths)}")
            check(len(widths) > 1, "path B streamed only one width")
            check(launched == {"kv_dequant": 0, "kv_dequant_mixed": 1},
                  f"path B: dequant launches {launched}, not one "
                  "kv_dequant_mixed")
            for k in launched:
                launches[k] += launched[k]

        # path C: sparse prefill attention on path A's weights
        launches["block_sparse_attention"], perf["block_sparse_attention"] \
            = path_c(cfg, kept.pop("params"), att_err, device)
        t0 = time.perf_counter()
        launches["block_sparse_attention"] += block_size_sweep(att_err,
                                                               device)
        print(f"[path C] block sizes {time.perf_counter() - t0:.1f} s wall "
              "(host clock)", flush=True)
        # path D: decode attention over path A's sparkv cache
        launches["decode_attention"], perf["decode_attention"] = path_d(
            kept.pop("cache"), cfg.num_heads, att_err, device)
        # path K: both attention kernels at every config's head shapes
        t0 = time.perf_counter()
        k_launches = path_k(att_err, device)
        for name, n in k_launches.items():
            launches[name] += n
            perf[name]["max_abs_err"] = att_err[name]
        print(f"[path K] {time.perf_counter() - t0:.1f} s wall (host clock), "
              f"launches {k_launches}", flush=True)

        # path E1: serve_fleet on path A's server, then one load_context a
        # streaming policy the fleet admitted
        K.reset_launches()
        loads = path_e1(kept.pop("server"), kept.pop("cid"), device)
        check(loads, "path E1: the fleet admitted no streaming policy")
        for policy, n_streamed, launched in loads:
            want = 1 if n_streamed else 0
            check(launched == {"kv_dequant": want, "kv_dequant_mixed": 0},
                  f"path E1 {policy}: dequant launches {launched}, not "
                  f"{want} kv_dequant for {n_streamed} streamed chunks")
        check(any(n for _, n, _ in loads),
              "path E1: no admitted request streamed a chunk")
        e1 = dict(K.LAUNCHES)
        check(e1["kv_dequant"] == sum(1 for _, n, _ in loads if n),
              f"path E1 launched kv_dequant {e1['kv_dequant']} times")
        for k in e1:
            launches[k] += e1[k]
        # path E2: the standalone fleet with the planner on the card
        path_e2(cfg, device)
        kept.clear()
        free_card()

        # path F: the MoE family through the serving loop
        f_launches, f_err = path_f(get_config("granite-moe-3b-a800m"),
                                   SparKVConfig(chunk_tokens=1024), device)
        for k in f_launches:
            launches[k] += f_launches[k]
        perf["kv_dequant"]["max_abs_err"] = max(
            perf["kv_dequant"]["max_abs_err"], f_err)
        # path G: the SSM and hybrid families on their own entry points
        for arch in ("mamba2-130m", "zamba2-2.7b"):
            path_g(get_config(arch), device)
        # path H: Whisper; paths T1 and T2: training, checkpoints, restart
        path_h(get_config("whisper-tiny"), device)
        t1 = path_t1(get_config("qwen2.5-3b"), device)
        # path S: the same training through the sharded step on a
        # one-rank NCCL mesh
        path_s(get_config("qwen2.5-3b"), device, t1)
        del t1
        free_card()
        path_t2(get_config("whisper-tiny"), device)
        # path P: prefill and decode over DTensors on a one-rank NCCL
        # mesh; path R: the dry run on a CUDA-typed fake 256-rank mesh
        for label, path in (("P", lambda: path_p(
                [cfg, get_config("mamba2-130m")], device)), ("R", path_r)):
            t0 = time.perf_counter()
            path()
            print(f"[path {label}] {time.perf_counter() - t0:.1f} s wall "
                  "(host clock)", flush=True)
        # path harness: the port's benchmark harness (fig8, fig4, quality)
        launches["kv_dequant"] += path_harness()
        # path X: the examples (quickstart, train_lm, serve_fleet,
        # serve_under_volatility, elastic_rescale)
        free_card()
        launches["kv_dequant"] += path_x(smi)
    except SmokeError as e:
        fail(str(e))

    print(f"[chip_smoke] {time.perf_counter() - t_start:.1f} s wall (host "
          "clock, the kernels' build included)", flush=True)
    table = [dict(name=name, **KERNELS[name], launches=launches[name],
                  **perf[name]) for name in KERNELS]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
