"""Routed experts of a decode-sized MoE step: the CUDA kernel and its
plain PyTorch version.

The kernel (``csrc/moe_decode.cu``) replaces no Pallas kernel: the
reference's MoE is XLA's. ``moe_decode`` runs the router, the top k, the
k routed experts and their ordered combine for t tokens in three
launches (router, gate and up, down and combine), adding one to
``LAUNCHES["moe_decode"]`` a call; the models' MoE block sends a decode
step there on the card (``models/layers.py::moe_block``). It reads only
the routed experts' weights, and nothing of the routing reaches the host.

``moe_decode_plain`` computes the same function with torch ops, at the
eager dispatch's rounding points (``models/layers.py::moe_block_local``
with nothing dropped): the router's logits rounded to the dtype before
an fp32 softmax; the top k by a stable sort (ties to the lower expert),
renormalised with a clamp at 1e-9; each routed expert's gate and up
products rounded to the dtype, the activation rounded, the product
rounded, the down product rounded; the gated outputs added in fp32 in
ascending expert id, one after the other; the Switch aux loss. It
gathers only the routed experts' weights. The CPU path takes it
(``ops.py``); the card never does.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

LAUNCHES = {"moe_decode": 0}

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_DTYPE_CODE = {dt: i for i, dt in enumerate(_DTYPES)}    # the C code's
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}
# the C code's activation codes: silu, gelu with the tanh approximation
ACTIVATIONS = {"swiglu": 0, "silu": 0, "geglu": 1, "gelu": 1}
# csrc/moe_decode.cu's constants
_LANES = 8             # 16-byte vectors a tile row: 128 bytes
_ROWS = 32             # rows a ring stage (256 threads, 8 a row)
_MAX_K = 16            # kMaxK: the down kernel's cluster of k blocks
_MAX_E = 1024          # kMaxE: one router thread an expert
_MAX_SPLIT = 8         # kMaxSplit: the gate/up kernel's cluster
_ROUTER_THREADS = 1024
_ROUTER_CLUSTER = 8
_THREADS = 256         # the expert kernels' blocks
_STAGES_UP, _STAGES_DOWN = 4, 8
_MAX_SMEM = 227 * 1024 - 8192   # less the kernels' static shared memory
_MAX_GRID_Y = 65535


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------------------------
# Plain version
# ----------------------------------------------------------------------------


def _act(name: str):
    if ACTIVATIONS[name] == 0:
        return F.silu
    return lambda v: F.gelu(v, approximate="tanh")


def route_plain(xf, router, k: int):
    """The router of (t, d) tokens -> (probs (t, e) fp32, each token's k
    picks (t, k) in ascending expert id, their renormalised gates (t, k)
    fp32): logits rounded to the dtype, an fp32 softmax, the top k by a
    stable sort (ties to the lower expert)."""
    probs = torch.softmax((xf @ router).float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    ids, order = idx.sort(dim=1)
    return probs, ids, vals.gather(1, order)


def moe_decode_plain(x, router, w_gate, w_up, w_down, k: int,
                     activation: str = "swiglu"):
    """x: (..., d) tokens; router (d, e); w_gate, w_up (e, d, f); w_down
    (e, f, d) -> (y in x's shape and dtype, the aux loss, 0-d fp32)."""
    d = x.shape[-1]
    e = router.shape[1]
    xf = x.reshape(-1, d)
    t = xf.shape[0]
    probs, ids, gates = route_plain(xf, router, k)
    ids = ids.reshape(-1)
    counts = torch.zeros(e, dtype=torch.int64, device=x.device).scatter_add_(
        0, ids, torch.ones_like(ids))
    aux = e * torch.sum(probs.mean(0) * (counts.float() / (t * k)))
    xa = xf.repeat_interleave(k, dim=0)[:, None]              # (t * k, 1, d)
    up = torch.bmm(xa, w_up[ids])
    gate = torch.bmm(xa, w_gate[ids])
    out = torch.bmm(_act(activation)(gate) * up, w_down[ids])  # (t * k, 1, d)
    # the gated outputs added in ascending expert id, one after the other
    contrib = out.reshape(t, k, d).float() * gates[..., None]
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        y = y + contrib[:, j]
    return y.to(x.dtype).reshape(x.shape), aux


# ----------------------------------------------------------------------------
# CUDA launcher
# ----------------------------------------------------------------------------


def split_plan(d: int, f: int, tk: int, itemsize: int, n_sm: int) -> int:
    """Blocks a gate/up sum for tk assignments (a cluster over slices of
    the d rows): the fewest of 1, 2, 4, 8 that give the launch two blocks
    an SM, and no more than the 32-row stages of d."""
    tiles = -(-f // (_LANES * 16 // itemsize))
    most = max(1, min(_MAX_SPLIT, -(-d // _ROWS)))
    for s in (1, 2, 4, 8):
        if s >= most or s * tiles * tk >= 2 * n_sm:
            return min(s, most)
    return most


def smem_bytes(d: int, f: int, e: int, k: int, itemsize: int,
               split: int = 1) -> tuple[int, int, int]:
    """Dynamic shared memory of the router, gate/up and down kernels."""
    nv = e // (16 // itemsize)
    rows = _ROUTER_THREADS // nv
    router = 4 * (-(-d // (4 * _ROUTER_CLUSTER)) * 4 + rows * e + 3 * e)
    up = _STAGES_UP * 2 * _THREADS * 16 + 4 * -(-d // split)
    down = _STAGES_DOWN * _THREADS * 16 + 4 * f
    return router, up, down


@functools.lru_cache(maxsize=None)
def workspace(t: int, f: int, e: int, k: int,
              itemsize: int) -> tuple[tuple[int, int, int, int], int]:
    """Byte offsets of probs (t, e) fp32, ids (t, k) int32, gates (t, k)
    fp32 and h (t * k, f) in the dtype in one workspace, each 256-byte
    aligned, and its size."""
    sizes = (4 * t * e, 4 * t * k, 4 * t * k, itemsize * t * k * f)
    offs, at = [], 0
    for n in sizes:
        offs.append(at)
        at += -(-n // 256) * 256
    return tuple(offs), at


def supported(t: int, d: int, f: int, e: int, k: int, dtype) -> bool:
    """Whether the kernel takes t tokens of width d through e experts of
    f, top k, in ``dtype``, on the card. Needs no card."""
    try:
        _check_shape(t, d, f, e, k, dtype)
    except ValueError:
        return False
    return True


def _check_shape(t, d, f, e, k, dtype):
    if dtype not in _DTYPES:
        raise ValueError(f"dtype {dtype}: the kernel takes {_DTYPES}")
    per = 16 // _ITEMSIZE[dtype]
    if min(t, d, f) < 1 or not 1 <= k <= min(e, _MAX_K) or e > _MAX_E:
        raise ValueError(f"t {t}, d {d}, f {f}, top {k} of {e} experts: "
                         f"the kernel takes top 1 to {_MAX_K} of at most "
                         f"{_MAX_E}")
    if d % per or f % per or e % per:
        raise ValueError(f"d {d}, f {f}, e {e}: each a multiple of {per} "
                         f"(16-byte rows in {dtype})")
    if t * k > _MAX_GRID_Y:
        raise ValueError(f"{t} x {k} assignments: at most {_MAX_GRID_Y}")
    if max(smem_bytes(d, f, e, k, _ITEMSIZE[dtype])) > _MAX_SMEM:
        raise ValueError(f"d {d}, f {f}, e {e}, top {k}: past the "
                         f"{_MAX_SMEM} bytes of shared memory a block")


def _check(x, router, w_gate, w_up, w_down, k, activation):
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r}: the kernel takes "
                         f"{sorted(ACTIVATIONS)}")
    d = x.shape[-1]
    if router.dim() != 2 or router.shape[0] != d:
        raise ValueError(f"router {tuple(router.shape)} must be (d, e) of "
                         f"x's d {d}")
    e = router.shape[1]
    if w_up.dim() != 3 or w_up.shape[:2] != (e, d) or \
            w_gate.shape != w_up.shape:
        raise ValueError(f"w_gate, w_up {tuple(w_up.shape)} must be "
                         f"(e, d, f) of e {e}, d {d}")
    f = w_up.shape[2]
    if tuple(w_down.shape) != (e, f, d):
        raise ValueError(f"w_down {tuple(w_down.shape)} must be "
                         f"({e}, {f}, {d})")
    _check_shape(x.numel() // d, d, f, e, k, x.dtype)
    ts = (x, router, w_gate, w_up, w_down)
    if any(w.dtype != x.dtype for w in ts):
        raise ValueError("x and the weights must share one dtype")
    if x.device.type != "cuda":
        raise ValueError(f"kernel needs CUDA tensors, got {x.device}")
    for w in ts:
        if w.device != x.device or not w.is_contiguous():
            raise ValueError("all inputs must be contiguous on one device")
        if w.data_ptr() % 16:
            raise ValueError("x and the weights must be 16-byte aligned")


_SM_COUNT: dict[int, int] = {}


def _sm_count(dev) -> int:
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _SM_COUNT:
        _SM_COUNT[i] = torch.cuda.get_device_properties(
            i).multi_processor_count
    return _SM_COUNT[i]


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("moe_decode")
        p, i = ctypes.c_void_p, ctypes.c_int
        # x, router, w_gate, w_up, w_down, y, aux, probs, ids, gates, h;
        # t, d, f, e, k, act, split, dtype; stream
        lib.moe_decode_launch.argtypes = [p] * 11 + [i] * 8 + [p]
        lib.moe_decode_launch.restype = i
        _LIB = lib
    return _LIB


def moe_decode(x, router, w_gate, w_up, w_down, k: int,
               activation: str = "swiglu"):
    """Launch the CUDA kernel: same contract as ``moe_decode_plain``, for
    contiguous, 16-byte aligned CUDA tensors of one dtype (fp32, bf16 or
    fp16) whose widths are whole 16-byte rows; anything else raises."""
    _check(x, router, w_gate, w_up, w_down, k, activation)
    d = x.shape[-1]
    t = x.numel() // d
    e, f = router.shape[1], w_up.shape[2]
    size = x.element_size()
    offs, nbytes = workspace(t, f, e, k, size)
    y = torch.empty_like(x)
    aux = torch.empty((), dtype=torch.float32, device=x.device)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    base = ws.data_ptr()
    err = _lib().moe_decode_launch(
        x.data_ptr(), router.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
        w_down.data_ptr(), y.data_ptr(), aux.data_ptr(),
        *(base + o for o in offs), t, d, f, e, k, ACTIVATIONS[activation],
        split_plan(d, f, t * k, size, _sm_count(x.device)),
        _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES["moe_decode"] += 1
    if err:
        raise RuntimeError(f"moe_decode launch failed: CUDA error {err}")
    return y, aux
