"""Device dispatch for GQA flash-decode.

The reference has no ``ops.py`` for this kernel: its tests call
``repro/kernels/decode_attn/kernel.py::decode_attention`` directly, with
``interpret`` choosing between the Pallas interpreter and the TPU. This
module keeps the port's kernel layout instead (ROADMAP.md, "Kernel
layout"): a CUDA kernel on the card (q, k, v, k2 and v2 in another layout
than contiguous and 16-byte aligned are copied first and counted in
``COPIES``), the plain version on the CPU, an error anywhere else.
On the card the models' decode step calls it
(``models/transformer.py::decode_attention``): one launch a layer a step
over the read-only context and the decode tail as two segments; on the
CPU and over DTensors the step keeps ``models/layers.py::flash_attention``
and ``merge_attention``, as the reference's does.
"""
from __future__ import annotations

from repro_torch.kernels._layout import dense
from repro_torch.kernels.decode_attn import kernel as K

# inputs copied into the kernels' layout (contiguous, 16-byte aligned)
COPIES = {"decode_attention": 0}


def decode_attention(q, k, v, kv_len: int, *, k2=None, v2=None,
                     kv_len2: int = 0, kv_block: int = 256,
                     scale: float | None = None):
    """q: (b, hq, d); k/v: (b, skv, hkv, d), in any layout; kv_len: valid
    cache length; k2/v2 (b, skv2, hkv, d), optional: a second segment
    whose first kv_len2 keys follow. Returns (b, hq, d)."""
    if q.device.type == "cuda":
        q, k, v = (dense(t, COPIES, "decode_attention") for t in (q, k, v))
        if k2 is not None:
            k2, v2 = (dense(t, COPIES, "decode_attention") for t in (k2, v2))
        return K.decode_attention(q, k, v, kv_len, k2=k2, v2=v2,
                                  kv_len2=kv_len2, kv_block=kv_block,
                                  scale=scale)
    if q.device.type == "cpu":
        return K.decode_attention_plain(q, k, v, kv_len, k2=k2, v2=v2,
                                        kv_len2=kv_len2, kv_block=kv_block,
                                        scale=scale)
    raise ValueError(f"no decode_attention for device {q.device}")
