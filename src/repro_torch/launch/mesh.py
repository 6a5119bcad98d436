"""Device meshes over ``torch.distributed`` (PyTorch).

Port of ``repro/launch/mesh.py``. A function, not a module constant, so
importing this module touches no process group. The single-pod mesh is
16x16 = 256 ranks (data, model); the multi-pod mesh adds a leading pod
axis: 2x16x16 = 512. Both meshes need a process group of that size,
started by the caller (a fake one serves a dry run); nothing here starts
one.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve


def _world(n_wanted=None) -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group is initialized; call "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    if n_wanted is not None and n != n_wanted:
        raise RuntimeError(f"the mesh needs {n_wanted} ranks, the process "
                           f"group has {n}")
    return n


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    _world(n)
    return init_device_mesh(resolve(device).type, shape,
                            mesh_dim_names=axes)


def make_local_mesh(shape=None, axes=("data", "model"), device=None):
    """Mesh over the initialized world (tests / single host), on `device`
    (default: the card); shape (1, world size) unless given."""
    n = _world()
    if shape is None:
        shape = (1, n)
    return init_device_mesh(resolve(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))
