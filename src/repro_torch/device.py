"""Where the port runs: the CUDA card unless the caller names the CPU.

There is no silent fallback. ``resolve()`` with no argument returns the
card and raises when there is none, so a run that was meant for the card
never measures the CPU by accident.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); else the named device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    return dev


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
