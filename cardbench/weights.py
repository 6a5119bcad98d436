"""Seeded weights, made on the run's device in the type they are served in.

One ``torch.randn`` call with a generator on the device fills a single
flat bfloat16 buffer; each leaf of the program's weight tree is a view of
it, scaled in place: norm offsets and most matrices by 0.02, the output
projections of attention and of the MLP or experts by 0.02 / sqrt(2 L).
The program is asked only for its tree's leaf names and shapes.
"""
from __future__ import annotations

import math

import torch

_OUT = ("wo", "w_down")
_ALIGN = 64          # elements: a leaf starts on a 128-byte boundary


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make(abstract: dict, num_layers: int, seed: int, device) -> dict:
    """A weight tree of `abstract`'s leaves (meta tensors, all of one
    dtype) on `device`."""
    leaves = list(_leaves(abstract))
    dtype = leaves[0][1].dtype
    if any(t.dtype != dtype for _, t in leaves):
        raise ValueError("the weights are of more than one dtype")
    size = [-(-t.numel() // _ALIGN) * _ALIGN for _, t in leaves]
    total = sum(size)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out: dict = {}
    at = 0
    out_scale = 0.02 / math.sqrt(2 * num_layers)
    for (path, t), n in zip(leaves, size):
        leaf = flat[at:at + t.numel()].view(t.shape)
        at += n
        leaf.mul_(out_scale if path[-1] in _OUT else 0.02)
        _put(out, path, leaf)
    return out
