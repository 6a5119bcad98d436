"""Parameters of the JAX package, as numpy arrays, -> the port's tensors.

The port keeps the reference's param tree (same keys, same layouts), so
conversion is a structural map that keeps every dtype. bf16 arrays come
out of ``np.asarray`` as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses; they cross as their uint16 bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.predictor import FeatureScaler
from repro_torch.device import resolve


def to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def convert_params(tree, device=None):
    """Nested dict of arrays -> nested dict of tensors on `device`."""
    dev = resolve(device)
    if isinstance(tree, dict):
        return {k: convert_params(v, dev) for k, v in tree.items()}
    return to_tensor(tree, dev)


def convert_predictor(params, scaler, device=None):
    """The latency MLP's [{"w", "b"}, ...] layers and its feature scaler
    -> (layers as tensors on `device`, the port's FeatureScaler)."""
    dev = resolve(device)
    layers = [{k: to_tensor(v, dev) for k, v in lyr.items()}
              for lyr in params]
    return layers, FeatureScaler(np.asarray(scaler.mean),
                                 np.asarray(scaler.std),
                                 float(scaler.y_scale))
