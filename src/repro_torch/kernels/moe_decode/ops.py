"""Device dispatch for the routed experts of a decode-sized MoE step.

The reference has no kernel for this: its MoE is XLA's. This module
keeps the port's kernel layout (ROADMAP.md, "Kernel layout"): the CUDA
kernel on the card (inputs in another layout than contiguous and 16-byte
aligned are copied first and counted in ``COPIES``), the plain version
on the CPU, an error anywhere else. On the card the models' MoE block
calls it for a decode step (``models/layers.py::moe_block``, where
``decode_route`` holds); every other MoE call keeps
``moe_block_local`` or ``moe_block_sharded``.
"""
from __future__ import annotations

from repro_torch.kernels._layout import dense
from repro_torch.kernels.moe_decode import kernel as K

# inputs copied into the kernel's layout (contiguous, 16-byte aligned)
COPIES = {"moe_decode": 0}


def moe_decode(x, router, w_gate, w_up, w_down, k: int,
               activation: str = "swiglu"):
    """x: (..., d) tokens; router (d, e); w_gate, w_up (e, d, f); w_down
    (e, f, d), in any layout -> (y in x's shape and dtype, aux loss)."""
    if x.device.type == "cuda":
        ts = (dense(t, COPIES, "moe_decode")
              for t in (x, router, w_gate, w_up, w_down))
        return K.moe_decode(*ts, k, activation)
    if x.device.type == "cpu":
        return K.moe_decode_plain(x, router, w_gate, w_up, w_down, k,
                                  activation)
    raise ValueError(f"no moe_decode for device {x.device}")
