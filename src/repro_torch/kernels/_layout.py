"""The layout the CUDA kernels read: contiguous, 16-byte aligned.

The reference's kernels take a tensor in any layout. The launchers take
only contiguous, 16-byte aligned storage and raise on anything else, so
the ``ops`` layers hand them ``dense`` copies of other layouts and count
each copy, which lets a run show that its path never needed one.
"""
from __future__ import annotations

import torch


def dense(t: torch.Tensor, copies: dict, name: str) -> torch.Tensor:
    """`t` itself where it is contiguous and 16-byte aligned, else a
    contiguous copy in fresh (aligned) storage, counted in
    ``copies[name]``."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    copies[name] += 1
    return torch.empty_like(t, memory_format=torch.contiguous_format
                            ).copy_(t)
