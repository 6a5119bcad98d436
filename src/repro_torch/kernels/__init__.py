"""Hand-written Hopper kernels with their plain PyTorch versions.

Each kernel package mirrors ``repro/kernels/<name>/``: ``kernel.py``
(the CUDA launcher and the plain version), ``ops.py`` (wire format ->
tensor, dispatch on the tensor's device) and ``ref.py`` (the oracle).
``huffman_decode`` has no counterpart there: the reference decodes on
the host, and its decoder is the CPU path and the oracle. CUDA sources
live in ``repro_torch/csrc/``.
"""
