#!/usr/bin/env python3
"""Time the port's kernels in two source trees on one card, in turns (A,
B, B, A), at the shapes of chip_smoke.py's paths A, C, D and O.

  python3 tools/kernel_ab.py PATH_A PATH_B [--out FILE]

Each PATH is the root of a checkout of this repository (for example the
parent commit unpacked with `git archive` into a git-ignored directory,
and `.`). Each turn is a subprocess that imports that tree's
`repro_torch` and `chip_smoke.time_ms` (CUDA events, median of 50
launches, L2 flushed before each) and builds that tree's kernels into its
own `build/`. The inputs are the same in every turn, drawn from a seeded
torch.Generator on the card:

- block-sparse, bf16: q (32 heads, 8192 tokens, 128), k/v (8 heads), the
  causal lists of kernels/block_sparse_attn/ops.block_lists at the
  serving mass 0.98 (path C's shape; path C takes layer 0's q/k/v of
  random weights instead of random q/k/v), and the same in fp32 (the
  CUDA-core kernel); and path K's gemma-2b (8/1 heads of 256) and
  zamba2-2.7b (32/32 heads of 80) shapes over 2048 tokens;
- decode, bf16: q (1, 32, 128) over k/v (1, 32768, 8, 128) at kv_len
  2048 (path D) and 32000 (path D's long cache);
- the generic kernels at chip_smoke path O's full-width shapes, bf16:
  block-sparse q (32 heads, 2040 tokens, 96), k/v (8 heads) in (24, 24)
  blocks on the causal lists at the serving mass, and decode q (1, 40,
  96) over k/v (1, 32000, 2, 96) at kv_len 32000;
- dequant, fp32 out: a cachegen request of path A (144 chunk tensors of
  1024 x 8 x 128 5-bit codes, group 64) staged by
  kernels/kv_dequant/ops.stage into K and V caches, one kv_dequant
  launch (chip_smoke.py phase 2's request, drawn by its _request_chunks
  from a seeded numpy generator).

Prints one JSON line a turn and, with --out, writes them all to FILE.
Without a card it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

TURN = r"""
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {src!r})
import torch
import numpy as np
from chip_smoke import _request_chunks, time_ms
from repro_torch.configs import SparKVConfig
from repro_torch.kernels.block_sparse_attn import kernel as BK
from repro_torch.kernels.block_sparse_attn.ops import block_lists
from repro_torch.kernels.decode_attn import kernel as DK
from repro_torch.kernels.kv_dequant import kernel as K
from repro_torch.kernels.kv_dequant import ops as KO

dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
bf = torch.bfloat16
q = torch.randn((32, 8192, 128), generator=gen, device=dev).to(bf)
k = torch.randn((8, 8192, 128), generator=gen, device=dev).to(bf)
v = torch.randn((8, 8192, 128), generator=gen, device=dev).to(bf)
idx, cnt = block_lists(q, k, 4, mass=SparKVConfig().attention_mass,
                       q_block=128, kv_block=128, causal=True)
dq = torch.randn((1, 32, 128), generator=gen, device=dev).to(bf)
dk = torch.randn((1, 32768, 8, 128), generator=gen, device=dev).to(bf)
dv = torch.randn((1, 32768, 8, 128), generator=gen, device=dev).to(bf)
flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
out = {{"tree": {root!r}, "card": torch.cuda.get_device_name(0),
        "tiles": int(cnt.sum())}}
out["block_sparse_ms"] = time_ms(
    lambda: BK.block_sparse_attention(q, k, v, idx, cnt, kv_group=4), flush)
q32, k32, v32 = (x.float() for x in (q, k, v))
out["block_sparse_fp32_ms"] = time_ms(
    lambda: BK.block_sparse_attention(q32, k32, v32, idx, cnt, kv_group=4),
    flush)
del q32, k32, v32
for name, hq, hkv, d in (("d256", 8, 1, 256), ("d80", 32, 32, 80)):
    sq, sk, sv = (torch.randn((h, 2048, d), generator=gen,
                              device=dev).to(bf) for h in (hq, hkv, hkv))
    si, sc = block_lists(sq, sk, hq // hkv,
                         mass=SparKVConfig().attention_mass, q_block=128,
                         kv_block=128, causal=True)
    out[f"block_sparse_{{name}}_ms"] = time_ms(
        lambda: BK.block_sparse_attention(sq, sk, sv, si, sc,
                                          kv_group=hq // hkv), flush)
for n in (2048, 32000):
    out[f"decode_{{n}}_ms"] = time_ms(
        lambda: DK.decode_attention(dq, dk, dv, n), flush)
del q, k, v, dq, dk, dv
gq, gk, gv = (torch.randn((h, 2040, 96), generator=gen, device=dev).to(bf)
              for h in (32, 8, 8))
gi, gc = block_lists(gq, gk, 4, mass=SparKVConfig().attention_mass,
                     q_block=24, kv_block=24, causal=True)
out["block_sparse_generic_ms"] = time_ms(
    lambda: BK.block_sparse_attention(gq, gk, gv, gi, gc, q_block=24,
                                      kv_block=24, kv_group=4), flush)
oq = torch.randn((1, 40, 96), generator=gen, device=dev).to(bf)
ok, ov = (torch.randn((1, 32000, 2, 96), generator=gen, device=dev).to(bf)
          for _ in range(2))
out["decode_generic_ms"] = time_ms(
    lambda: DK.decode_attention(oq, ok, ov, 32000), flush)
del gq, gk, gv, oq, ok, ov
qts, caches = _request_chunks(np.random.default_rng(0), 36, [5], dev)
cache, dests = caches()
batch = KO.stage(qts, dests, mixed=False)
out["dequant_cachegen_ms"] = time_ms(lambda: K.dequant_batch(batch), flush)
print(json.dumps(out), flush=True)
"""


def turn(root):
    root = os.path.abspath(root)
    code = TURN.format(root=root, src=os.path.join(root, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr)
        raise SystemExit(f"turn in {root} failed ({proc.returncode})")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--out")
    args = ap.parse_args()
    rows = []
    for root in (args.a, args.b, args.b, args.a):
        rows.append(turn(root))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
