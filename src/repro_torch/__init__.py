"""SparKV on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``repro``, module for module at the same
relative paths. ``repro`` stays the reference; this package imports
neither it nor JAX. Numpy-only modules (``configs``, ``compression``,
``data``, most of ``core``) are kept as copies here, so the two packages
can be held against each other by tests that import both.
"""
