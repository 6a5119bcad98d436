"""Where the port runs: the CUDA card unless the caller names the CPU.

There is no silent fallback. ``resolve()`` with no argument returns the
card and raises when there is none, so a run that was meant for the card
never measures the CPU by accident. A caller that was handed a device
(a CLI's ``--device``) names it for everything it calls with
``named(device)``: inside that block ``resolve()`` returns it, which
reaches the modules that take no device argument, such as the planner
cache of ``core/baselines.py`` (a copy of the reference).
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

# the device a caller named for what it calls (``named``), else None
_NAMED = contextvars.ContextVar("repro_torch_device", default=None)


@contextlib.contextmanager
def named(device):
    """Within the block, ``resolve()`` with no argument gives `device`
    (resolved first: a named card still raises without one)."""
    dev = resolve(device)
    token = _NAMED.set(dev)
    try:
        yield dev
    finally:
        _NAMED.reset(token)


def resolve(device=None) -> torch.device:
    """``None`` -> the device a caller named (``named``), else ``cuda``
    (raises without a card); else the named device."""
    if device is None:
        device = _NAMED.get()
        if device is not None:
            return device
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
