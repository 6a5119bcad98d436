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
     (ragged entries, several widths, fp32 and bf16; nothing written
     outside the entries) and whole requests: one launch over a cachegen
     request's 144 chunk tensors and over path B's 16 (mixed form), timed
     beside its plain version and, for the uniform form, in turns with
     the one torch.addcmul call that computes the same values;
  3. path A: sparkv-qwen3-4b at full width and depth, random weights from
     a seed; one 2048-token context (1024-token chunks, 72 KV chunks);
     three requests (sparkv, cachegen, local_prefill), 8 new tokens each,
     each streaming request dequantized in exactly one kv_dequant launch;
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
  6. path D: decode attention over path A's cachegen cache, one
     kernels/decode_attn/ops.decode_attention call per layer (36 calls,
     one kernel launch each), each against the plain version and
     layers.flash_attention; then one long cache (32768 positions,
     kv_len 32000) in bf16 and fp32.

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
    written once, each group's two parameters and each table row read
    once."""
    n = sum(int(np.prod(q.shape)) for q in qts)
    g = sum(q.scales.shape[0] for q in qts)
    return n * (1 + out_bytes) + 8 * g + 32 * len(qts), n, g


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
                            (129, 128, 32), (5, 192, 64)):
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
                            (7, 128, 32)):
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


def path_c(cfg, params, err, device, *, n_tokens=8192, seed=0):
    """Sparse prefill attention at full width on layer 0's q/k/v; returns
    (launches during the path, the kernel's perf entry)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import SparKVConfig
    from repro_torch.kernels.block_sparse_attn import kernel as BK
    from repro_torch.kernels.block_sparse_attn import ops as BO
    from repro_torch.kernels.block_sparse_attn.ref import block_mask_dense
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import layer_params

    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          size=(1, n_tokens)), device=device)
    bp = layer_params(params["blocks"], 0)
    h = L.apply_norm(cfg, params["emb"][tokens], bp["attn_norm"])
    q, k, v = L.attention_qkv(cfg, bp["attn"], h,
                              torch.arange(n_tokens, device=device))
    hq, hkv, d = q.shape[2], k.shape[2], q.shape[3]
    g, qb = hq // hkv, 128
    n_qb = n_tokens // qb
    mass = SparKVConfig().attention_mass
    print(f"[path C] layer 0 q {tuple(q.shape)} k/v {tuple(k.shape)} "
          f"{q.dtype}; {n_qb} q-blocks, mass {mass}", flush=True)

    # observe the lists that sparse_prefill_attention hands the kernel,
    # without changing the call
    seen = {}
    launch = BK.block_sparse_attention

    def launch_and_keep(*args, **kw):
        seen["args"] = args
        return launch(*args, **kw)

    BK.reset_launches()
    BK.block_sparse_attention = launch_and_keep
    try:
        t0 = time.perf_counter()
        out, cnt = BO.sparse_prefill_attention(q, k, v, mass=mass)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        BK.block_sparse_attention = launch
    launches = BK.LAUNCHES["block_sparse_attention"]
    check(launches == 1, f"path C: {launches} block-sparse launches, not 1")
    qf, kf, vf, idx, cnt2 = seen["args"]
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
    q4, k4, v4 = (x.view(1, -1, n_tokens, d) for x in (qf, kf, vf))
    tok = block_mask_dense(idx, cnt2, n_qb, n_qb)
    tok = tok.repeat_interleave(qb, 1).repeat_interleave(qb, 2)
    tok &= torch.ones(n_tokens, n_tokens, dtype=torch.bool,
                      device=device).tril()
    mask = tok.view(1, hq, n_tokens, n_tokens)
    ms, lib_ms = time_in_turns(
        lambda: BK.block_sparse_attention(qf, kf, vf, idx, cnt2, kv_group=g),
        lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                               enable_gqa=True), flush)
    del tok, mask
    full_ms, dense_ms = time_in_turns(
        lambda: BK.block_sparse_attention(qf, kf, vf, full_idx, full_cnt,
                                          kv_group=g),
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                               enable_gqa=True), flush)
    # bound: q, k, v, o and the lists moved once; 4 * d operations (QK^T
    # and PV) for each (query, key) pair the causal mask leaves
    nbytes = ((qf.numel() + kf.numel() + vf.numel() + qf.numel()) * 2
              + (idx.numel() + cnt2.numel()) * 4)
    pairs = _causal_pairs(idx, cnt2, qb, qb)
    ops = 4 * d * pairs
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


def path_d(cache, hq, err, device, *, seed=0):
    """Decode attention over path A's assembled cache, one call per
    layer; returns (launches during the path, the kernel's perf entry)."""
    import torch
    import torch.nn.functional as F
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
        bq, bk, bv = (q.view(b, hq, 1, d), k[:, :n].transpose(1, 2),
                      v[:, :n].transpose(1, 2))
        ms, lib_ms = time_in_turns(
            lambda: DK.decode_attention(q, k, v, n),
            lambda: F.scaled_dot_product_attention(bq, bk, bv,
                                                   enable_gqa=True), flush)
        plain_ms = time_ms(lambda: DK.decode_attention_plain(q, k, v, n),
                           flush)
        nbytes = (2 * n * hkv * d + 2 * b * hq * d) * k.element_size()
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
               max_new=8, keep=None):
    """Register one context and serve one request per policy; returns the
    kernels' launches during the path, reset just before it. `keep`, a
    dict, receives the server's params and the cachegen request's cache."""
    from repro_torch.device import sync
    from repro_torch.kernels.kv_dequant import kernel as K

    rng = np.random.default_rng(seed)
    srv, seen = build_server(cfg, spcfg, device, seed)
    if keep is not None:
        keep["params"], keep["server"] = srv.params, srv
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
        keep["context"] = st
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
        if policy == "cachegen":
            cache = seen["cache"]
            err = max(float((cache["k"].float() - ex_k).abs().max()),
                      float((cache["v"].float() - ex_v).abs().max()))
            print(f"[{label}] cachegen cache max |err| {err:.6f} "
                  f"(bound {2 * step_bound + 1e-4:.6f})")
            check(err <= 2 * step_bound + 1e-4,
                  "cachegen cache beyond two quantization steps")
            if keep is not None:
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

        # path A: full width and depth, uniform 5-bit chunks
        spcfg = SparKVConfig(chunk_tokens=1024)
        kept = {}
        for policy, res, launched, widths in serve_path(
                "path A", cfg, spcfg, 2048,
                ("sparkv", "cachegen", "local_prefill"), device, keep=kept):
            want = 1 if res.n_streamed else 0
            check(launched == {"kv_dequant": want, "kv_dequant_mixed": 0},
                  f"{policy}: dequant launches {launched}, not {want} "
                  f"kv_dequant for {res.n_streamed} streamed chunks")
            for k in launched:
                launches[k] += launched[k]
        check(launches["kv_dequant"] == 2,
              f"path A launched kv_dequant {launches['kv_dequant']} times, "
              "not 2")
        dequant_routes(kept.pop("server"), kept.pop("context"), device)
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
        # path D: decode attention over path A's cachegen cache
        launches["decode_attention"], perf["decode_attention"] = path_d(
            kept.pop("cache"), cfg.num_heads, att_err, device)
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
