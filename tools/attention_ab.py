#!/usr/bin/env python3
"""Time the port's two attention kernels in two source trees on one card,
in turns (A, B, B, A), at the shapes of chip_smoke.py's paths C and D.

  python3 tools/attention_ab.py PATH_A PATH_B [--out FILE]

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
  random weights instead of random q/k/v);
- decode, bf16: q (1, 32, 128) over k/v (1, 32768, 8, 128) at kv_len
  2048 (path D) and 32000 (path D's long cache).

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
from chip_smoke import time_ms
from repro_torch.configs import SparKVConfig
from repro_torch.kernels.block_sparse_attn import kernel as BK
from repro_torch.kernels.block_sparse_attn.ops import block_lists
from repro_torch.kernels.decode_attn import kernel as DK

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
for n in (2048, 32000):
    out[f"decode_{{n}}_ms"] = time_ms(
        lambda: DK.decode_attention(dq, dk, dv, n), flush)
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
