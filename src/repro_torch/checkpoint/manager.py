"""Checkpointing for fault tolerance (PyTorch).

Port of ``repro/checkpoint/manager.py``, writing the same files, so a
checkpoint written by either package restores in the other:
  - every leaf is a separate ``leaf_{i}.npy`` inside a step directory
    with an ``index.json`` (treedef, shapes, logical dtypes, step); leaf i
    is the i-th leaf in ``jax.tree.flatten`` order (``repro_torch.tree``);
    bf16 is stored as its uint16 bit view with logical dtype "bfloat16";
  - writes go to <dir>/tmp-<step> and are COMMITTED by atomic rename to
    <dir>/step-<step>; a crash mid-write never corrupts the latest commit;
  - saves copy every leaf to the host, then write on a background thread
    (training continues, and may update the params in place); `wait()`
    joins;
  - retention: keep the last `keep` commits.
Re-sharding on restore (``shardings``) waits for the mesh port.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.tree import flatten, unflatten

def _to_host(x: torch.Tensor) -> tuple[np.ndarray, str]:
    """(a host copy of a leaf as it is stored, its logical dtype). The
    copy is never a view of a tensor the caller may go on changing; bf16
    is stored as its uint16 bit view."""
    t = x.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ---------- save ----------
    def save(self, state: dict, step: int, *, block: bool = False):
        leaves, treedef = flatten(state)
        host_leaves = [_to_host(x) for x in leaves]
        self.wait()
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write, args=(host_leaves, treedef, step),
                daemon=True)
            self._thread.start()
        else:
            self._write(host_leaves, treedef, step)

    def _write(self, leaves, treedef, step: int):
        tmp = os.path.join(self.dir, f"tmp-{step}")
        final = os.path.join(self.dir, f"step-{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        index = {
            "step": step,
            "time": time.time(),
            "treedef": str(treedef),
            "leaves": [],
        }
        for i, (arr, logical) in enumerate(leaves):
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
            index["leaves"].append({
                "i": i, "shape": list(arr.shape), "dtype": logical,
            })
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                     # atomic commit
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step-{s}"),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        self._thread = None

    # ---------- restore ----------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step-"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "index.json")):
                    out.append(int(name.split("-")[1]))
        return sorted(out)

    def restore(self, step: int, *, like: Optional[dict] = None,
                device=None, shardings: Optional[dict] = None):
        """Returns the state tree on `device` (default: the card). `like`
        (a tree of tensors) provides the structure and each leaf's
        dtype."""
        if shardings is not None:
            raise NotImplementedError(
                "re-sharding on restore waits for the mesh port "
                "(ROADMAP.md, queue 1, item 7)")
        path = os.path.join(self.dir, f"step-{step}")
        with open(os.path.join(path, "index.json")) as f:
            index = json.load(f)
        leaves = [self._load_leaf(path, e) for e in index["leaves"]]
        if like is None:
            raise ValueError("restore requires `like` for the treedef")
        like_leaves, treedef = flatten(like)
        if len(like_leaves) != len(leaves):
            raise ValueError(f"checkpoint step {step} has {len(leaves)} "
                             f"leaves, `like` {len(like_leaves)}")
        dev = resolve(device)
        return unflatten(treedef, [x.to(dev, dtype=l.dtype)
                                   for x, l in zip(leaves, like_leaves)])

    @staticmethod
    def _load_leaf(path: str, entry: dict) -> torch.Tensor:
        arr = np.load(os.path.join(path, f"leaf_{entry['i']}.npy"))
        logical = entry["dtype"]
        if logical == "bfloat16":
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        if str(arr.dtype) != logical:
            raise ValueError(f"leaf {entry['i']}: logical dtype {logical} "
                             f"stored as {arr.dtype}")
        return torch.from_numpy(arr)

    def restore_latest(self, *, like: Optional[dict] = None, device=None,
                       shardings: Optional[dict] = None):
        steps = self.all_steps()
        if not steps:
            return None
        if like is None:
            return self._restore_raw(steps[-1]), steps[-1]
        return self.restore(steps[-1], like=like, device=device,
                            shardings=shardings), steps[-1]

    def _restore_raw(self, step: int):
        """Structure-free restore (list of arrays + index) — used by the
        trainer which knows its own structure."""
        path = os.path.join(self.dir, f"step-{step}")
        with open(os.path.join(path, "index.json")) as f:
            index = json.load(f)
        leaves = [np.load(os.path.join(path, f"leaf_{e['i']}.npy"))
                  for e in index["leaves"]]
        return {"_leaves": leaves, "_index": index}
