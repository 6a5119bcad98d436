"""Wrapper: Huffman-coded chunk tensors (``compression.huffman``'s
``EncodedChunk``, the wire format) -> their quantization codes, decoded
by the CUDA kernel on the card and by the reference's decoder on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.compression import huffman
from repro_torch.kernels.huffman_decode import kernel as K


def decode(encs: list, device) -> list:
    """Each of `encs` decoded to its codes in the reference's flat order.
    Dispatch on `device`: on the card one kernel launch over all of them
    (uint8 codes), on the CPU ``huffman.decode`` each (uint16), an error
    anywhere else."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return K.decode_chunks(encs, dev)
    if dev.type == "cpu":
        return [huffman.decode(e) for e in encs]
    raise ValueError(f"no huffman_decode for device {dev}")
