"""Build a CUDA source of ``repro_torch/csrc/`` into a shared library and
load it with ctypes.

Each library is compiled by ``nvcc`` for ``sm_90a`` at first use, into
``build/repro_torch/`` at the root of the checkout, under a name keyed by
a hash of its source, of every header (``*.cuh``) under ``csrc/`` and of
the flags: a changed source or header rebuilds, an unchanged one is
loaded as built. ptxas's report (registers, shared memory and spills of
each kernel) is kept beside the library (``ptxas_report``). A missing
``nvcc`` or a failed build raises; nothing falls back to another
implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels of repro_torch cannot be built")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to for its current source and
    headers."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def ptxas_report(name: str) -> str:
    """What ptxas said when it built ``csrc/<name>.cu`` (``-Xptxas -v``)."""
    return library_path(name).with_suffix(".ptxas.txt").read_text()


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its keyed library exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    out.with_suffix(".ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, out)          # atomic: concurrent builds agree
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(build(name)))
        return _LIBS[name]
