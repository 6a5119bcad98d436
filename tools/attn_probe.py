#!/usr/bin/env python3
"""Where the generic attention kernels' time goes, read from the kernels'
own clock: chip_smoke.py path O's full-width generic shapes in bf16.

  python3 tools/attn_probe.py [--out FILE]

The card's machine has no Nsight tools, and torch.profiler gives a kernel's
total only. So this builds, from the checkout's sources, a standalone copy
of the two generic kernels (csrc/generic_attn.cuh with `%globaltimer` reads
added around the phases of its loop, and the kernels and launchers of
block_sparse_attn.cu and decode_attn.cu at path O's instances) into
build/attn_probe/, runs it once on each shape and prints:

- every CTA's start and duration (how many ran at once, and for how long);
- one CTA's timeline (CTA 0, thread 0): before its loop, then for each
  sub-tile the wait for its copies, the copies' issue (the next
  sub-tile's, before the products, or after them where the ring has three
  stages), QK, the softmax and P V, and the end-of-CTA merge;
- each kernel's device time from torch.profiler (decode: the splits' kernel
  and the combine), the call's time (chip_smoke.time_ms), and its error
  against the plain version.

The stamps cost a few registers and a store or two a sub-tile; the
kernels' times are chip_smoke's, not this copy's. Without a card it exits
non-zero.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")
OUT = os.path.join(ROOT, "build", "attn_probe")
# path O's instances: 24-row q-blocks (block-sparse) and 20 query heads a
# kv head (decode) are two m16 tiles, two groups of 16 keys a warp
ENG_B = "gen::Tc<bf16, 128, 2>"
ENG_D = "gen::Tc<bf16, 128, 2, 3>"
MAX_IT = 66


def _grab(src, start, end):
    a = src.index(start)
    return src[a:src.index(end, a)]


def _stamped_engine():
    """generic_attn.cuh with phase stamps in CTA 0's loop."""
    s = open(os.path.join(CSRC, "generic_attn.cuh")).read()
    edits = [
        ("namespace gen {\n",
         f"__device__ unsigned long long g_phase[2][{MAX_IT}][5];\n"
         "__device__ int g_which;\n"
         "#define XS(it, k) if (blockIdx.x == 0 && blockIdx.y == 0 && "
         f"threadIdx.x == 0 && (it) < {MAX_IT}) {{ unsigned long long t_; "
         "asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t_)); "
         "g_phase[g_which][(it)][(k)] = t_; }\n"
         "namespace gen {\n"),
        ("  eng.init(R);\n", "  XS(0, 0)\n  eng.init(R);\n"),
        ("    for (int it = 0; pend[0]; ++it) {\n",
         "    XS(0, 1)\n    for (int it = 0; pend[0]; ++it) {\n"),
        ("      __syncthreads();\n      auto next = [&] {",
         "      XS(it + 1, 0)\n      __syncthreads();\n"
         "      auto next = [&] {"),
        ("      if constexpr (!kLate) next();\n",
         "      if constexpr (!kLate) next();\n      XS(it + 1, 1)\n"),
        ("      eng.qk(qs, ks, P, Eng::ksteps(cw));\n",
         "      eng.qk(qs, ks, P, Eng::ksteps(cw));\n      XS(it + 1, 2)\n"),
        ("      if constexpr (kLate) next();\n    }\n",
         "      XS(it + 1, 3)\n      if constexpr (kLate) next();\n"
         "      XS(it + 1, 4)\n    }\n"),
        ("  __syncthreads();  // the ring's bytes take the partials\n",
         "  __syncthreads();  // the ring's bytes take the partials\n"
         "  XS(0, 2)\n"),
        ("  eng.finish(reinterpret_cast<float*>(smem), R, ncols, no, out);\n"
         "}",
         "  eng.finish(reinterpret_cast<float*>(smem), R, ncols, no, out);\n"
         "  XS(0, 3)\n}"),
    ]
    for old, new in edits:
        if old not in s:
            raise SystemExit(f"generic_attn.cuh changed: no {old!r}")
        s = s.replace(old, new, 1)
    return s


def _source():
    """A .cu with the stamped engine, path O's two instances and their
    launchers, each CTA's start and end stamped."""
    bsa = open(os.path.join(CSRC, "block_sparse_attn.cu")).read()
    dec = open(os.path.join(CSRC, "decode_attn.cu")).read()
    gk = "template <class Eng, bool BIG>\n__global__ void __launch_bounds__"
    gl = "template <class Eng, bool BIG>\nint launch_generic("
    parts = []
    for src, name in ((bsa, "bsa_generic_kernel"),
                      (dec, "decode_generic_kernel")):
        # decode's text runs on through the combine kernel
        k = _grab(src, gk + f"(gen::kThreads)\n{name}", gl)
        k = k.replace("extern __shared__ float4 smem4[];",
                      "extern __shared__ float4 smem4[];\n  STAMP0", 1)
        end = k.index("});", k.index("gen::attend<Eng, BIG>(")) + 3
        k = k[:end] + "\n  STAMP1" + k[end:]
        parts.append(k + _grab(src, gl, "// The instance of a head size"))
    return f'''#include <cuda_runtime.h>
#include "generic_attn.cuh"
__device__ unsigned long long g_cta[8192][2];
#define STAMP0 unsigned long long t_b; asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t_b));
#define STAMP1 if (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.x < 8192) {{ unsigned long long t_e; asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t_e)); g_cta[blockIdx.x][0] = t_b; g_cta[blockIdx.x][1] = t_e; }}
namespace {{
using namespace sm90;
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp2_or_0(float x, float m) {{
  return x == -INFINITY ? 0.f : exp2f(x - m);
}}
namespace B {{
{parts[0]}}}
namespace D {{
{parts[1]}}}
}}
extern "C" {{
int read_stamps(unsigned long long* cta, unsigned long long* phase) {{
  cudaError_t e = cudaMemcpyFromSymbol(cta, g_cta, sizeof(g_cta));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(phase, g_phase, sizeof(g_phase));
  return (int)e;
}}
int set_which(int w) {{ return (int)cudaMemcpyToSymbol(g_which, &w, sizeof(int)); }}
int bsa(const void* q, const void* k, const void* v, const void* idx, const void* cnt, void* o, int bh, int sq, int skv, int d, int n_qb, int max_nnz, int q_block, int kv_block, int kv_group, int causal, float scale, void* s) {{
  return B::launch_generic<{ENG_B}, false>(q, k, v, idx, cnt, o, bh, sq, skv, d, n_qb, max_nnz, q_block, kv_block, kv_group, causal, scale, (cudaStream_t)s);
}}
int dec(const void* q, const void* k, const void* v, void* out, void* ws, int b, int skv, int hq, int hkv, int d, int kv_len, int chunk, int n_split, float scale, void* s) {{
  return D::launch_generic<{ENG_D}, false>(q, k, v, k, v, out, ws, b, skv, skv, hq, hkv, d, kv_len, 0, chunk, n_split, scale, (cudaStream_t)s);
}}
}}
'''


def build():
    from repro_torch.kernels import _build
    os.makedirs(OUT, exist_ok=True)
    for name in ("generic_attn.cuh", "mma_sm90.cuh"):
        body = (_stamped_engine() if name == "generic_attn.cuh"
                else open(os.path.join(CSRC, name)).read())
        with open(os.path.join(OUT, name), "w") as f:
            f.write(body)
    with open(os.path.join(OUT, "probe.cu"), "w") as f:
        f.write(_source())
    lib = os.path.join(OUT, "libprobe.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib,
           os.path.join(OUT, "probe.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(proc.stderr[-4000:])
    return ctypes.CDLL(lib)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from chip_smoke import time_ms
    from repro_torch.configs import SparKVConfig
    from repro_torch.kernels.block_sparse_attn import kernel as BK
    from repro_torch.kernels.block_sparse_attn.ops import block_lists
    from repro_torch.kernels.decode_attn import kernel as DK
    lib = build()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bsa.argtypes = [p] * 6 + [i] * 10 + [ctypes.c_float, p]
    lib.dec.argtypes = [p] * 5 + [i] * 8 + [ctypes.c_float, p]
    lib.read_stamps.argtypes = [p, p]
    lib.set_which.argtypes = [i]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    gq, gk, gv = (torch.randn((h, 2040, 96), generator=gen,
                              device=dev).to(bf) for h in (32, 8, 8))
    gi, gc = block_lists(gq, gk, 4, mass=SparKVConfig().attention_mass,
                         q_block=24, kv_block=24, causal=True)
    ob = torch.empty_like(gq)
    oq = torch.randn((1, 40, 96), generator=gen, device=dev).to(bf)
    ok, ov = (torch.randn((1, 32000, 2, 96), generator=gen,
                          device=dev).to(bf) for _ in range(2))
    od = torch.empty_like(oq)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk, n_split = DK.split_plan_generic(2, 32000, n_sm)
    ws = torch.empty(DK.workspace_floats(1, 40, 96, n_split), device=dev)
    runs = {
        "block_sparse 32/8x96 (24, 24) 2040": (
            lambda: lib.bsa(gq.data_ptr(), gk.data_ptr(), gv.data_ptr(),
                            gi.data_ptr(), gc.data_ptr(), ob.data_ptr(),
                            32, 2040, 2040, 96, 85, gi.shape[-1], 24, 24, 4,
                            1, 96 ** -0.5, stream()),
            32 * 85, ob, lambda: BK.block_sparse_attention_plain(
                gq, gk, gv, gi, gc, q_block=24, kv_block=24, kv_group=4)),
        "decode 40/2x96 len 32000": (
            lambda: lib.dec(oq.data_ptr(), ok.data_ptr(), ov.data_ptr(),
                            od.data_ptr(), ws.data_ptr(), 1, 32000, 40, 2,
                            96, 32000, chunk, n_split, 96 ** -0.5,
                            stream()),
            2 * n_split, od,
            lambda: DK.decode_attention_plain(oq, ok, ov, 32000)),
    }
    report = {"card": torch.cuda.get_device_name(0)}
    from torch.profiler import ProfilerActivity, profile
    for which, (label, (fn, n_cta, out, plain)) in enumerate(runs.items()):
        ms = time_ms(fn, flush)
        lib.set_which(which)
        flush.zero_()
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        cta = np.zeros((8192, 2), dtype=np.uint64)
        phase = np.zeros((2, MAX_IT, 5), dtype=np.uint64)
        if lib.read_stamps(cta.ctypes.data, phase.ctypes.data):
            raise SystemExit("reading the stamps failed")
        c = cta[:n_cta].astype(np.int64)
        t0 = c[:, 0].min()
        start, dur = (c[:, 0] - t0) / 1e3, (c[:, 1] - c[:, 0]) / 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        kernels = {e.key.split("<")[0].split("::")[-1]:
                   round(e.device_time_total / e.count, 3)
                   for e in prof.key_averages()
                   if e.device_type.name == "CUDA"
                   and ("generic" in e.key or "combine" in e.key)}
        ph = phase[which].astype(np.int64)
        base = ph[0, 0]
        rel = lambda x: round((x - base) / 1e3, 3) if x else None  # noqa
        loop = [[rel(x) for x in ph[it]] for it in range(1, MAX_IT)
                if ph[it, 0]]
        rec = {
            "ms": ms, "max_abs_err": float((out.float() -
                                            plain().float()).abs().max()),
            "kernels_us": kernels, "ctas": n_cta,
            "cta_us": {"span": round(float(((c[:, 1] - t0) / 1e3).max()),
                                     3),
                       "median": round(float(np.median(dur)), 3),
                       "p10": round(float(np.percentile(dur, 10)), 3),
                       "p90": round(float(np.percentile(dur, 90)), 3),
                       "started_in_first_us": int((start < 1).sum())},
            "cta0_us": {"loop_from": rel(ph[0, 1]),
                        "merge": [rel(ph[0, 2]), rel(ph[0, 3])],
                        "subtiles": len(loop),
                        # per sub-tile: landed, copies issued (two stages),
                        # QK done, softmax and P V done, late copies issued
                        "first_subtiles": loop[:4]},
        }
        report[label] = rec
        print(f"[{label}] {json.dumps(rec)}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
