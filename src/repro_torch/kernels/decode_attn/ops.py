"""Device dispatch for GQA flash-decode.

The reference has no ``ops.py`` for this kernel: its tests call
``repro/kernels/decode_attn/kernel.py::decode_attention`` directly, with
``interpret`` choosing between the Pallas interpreter and the TPU. This
module keeps the port's kernel layout instead (ROADMAP.md, "Kernel
layout"): a CUDA kernel on the card (q, k and v in another layout than
contiguous and 16-byte aligned are copied first and counted in
``COPIES``), the plain version on the CPU, an error anywhere else.
Nothing in the models calls it; the port's decode step attends over the
context with ``models/layers.py::flash_attention``, as the reference's
does.
"""
from __future__ import annotations

from repro_torch.kernels._layout import dense
from repro_torch.kernels.decode_attn import kernel as K

# inputs copied into the kernels' layout (contiguous, 16-byte aligned)
COPIES = {"decode_attention": 0}


def decode_attention(q, k, v, kv_len: int, *, kv_block: int = 256,
                     scale: float | None = None):
    """q: (b, hq, d); k/v: (b, skv, hkv, d), in any layout; kv_len: valid
    cache length. Returns (b, hq, d)."""
    if q.device.type == "cuda":
        q, k, v = (dense(t, COPIES, "decode_attention") for t in (q, k, v))
        return K.decode_attention(q, k, v, kv_len, kv_block=kv_block,
                                  scale=scale)
    if q.device.type == "cpu":
        return K.decode_attention_plain(q, k, v, kv_len, kv_block=kv_block,
                                        scale=scale)
    raise ValueError(f"no decode_attention for device {q.device}")
