"""The routed-experts kernel's plain version and the route that sends a
decode step there, on the CPU.

``kernels/moe_decode/kernel.moe_decode_plain`` (what the CUDA kernel is
held to on the card) against ``models/layers.moe_block_local`` run
eagerly, at one-token shapes of the port's MoE widths: Granite-3.0
(1536/512, top 8 of 40), Granite-4.0-H (4096/768, top 10 of 72),
Qwen3-MoE (4096/1536, top 8 of 128) and a smoke width, t from 1 to the
route's limit. The big widths keep as many experts as their tokens need
(t * k), which is all the route reads, so the weights stay small.

Tolerances: the plain version computes the eager path's function at its
rounding points, with bmm over the routed experts instead of every
expert, so only the order of the fp32 sums inside a dot product can
differ. In fp32 that moves the output by ~1e-6 of its largest magnitude
at d = 1536 (atol 1e-5 of it; the worst order's error grows as d *
2^-24); in bf16 it can move a rounding of a gate, up, product or
expert output by one step (atol 2^-8, one bf16 step, of the largest
magnitude). The router's ops are the eager ones, so picks and aux are
equal. The kernel itself runs only on the card (tests/test_torch_cuda.py).

  PYTHONPATH=src python -m pytest -q tests/test_torch_moe_decode.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.kernels.moe_decode import kernel as MK  # noqa: E402
from repro_torch.kernels.moe_decode import ops as MO  # noqa: E402
from repro_torch.kernels.moe_decode import ref as MR  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

# (d, f, e, k, capacity_factor) and the largest t the route takes there
WIDTHS = {
    "smoke": ((64, 128, 8, 2, 1.25), 4),
    "granite-3.0": ((1536, 512, 40, 8, 1.25), 4),
    "granite-4.0-h": ((4096, 768, 72, 10, 7.2), 7),
    "qwen3-moe": ((4096, 1536, 128, 8, 1.25), 4),
}
BIG = ("granite-4.0-h", "qwen3-moe")
# the big widths in their working dtype, bf16, at one and two tokens
CASES = [(name, t, dtype) for name, (_, limit) in WIDTHS.items()
         for t in sorted({1, 2, limit}) if name not in BIG or t <= 2
         for dtype in (torch.float32, torch.bfloat16)
         if name not in BIG or dtype == torch.bfloat16]
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}


def _cfg(d, f, e, k, cf):
    cfg = get_smoke("granite-moe-3b-a800m", d_model=d, d_ff=f)
    return dataclasses.replace(cfg, moe=MoEConfig(
        num_experts=e, experts_per_token=k, capacity_factor=cf))


def _params(d, f, e, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    draw = lambda *s: (torch.randn(s, generator=g) * 0.02).to(dtype)
    return {"router": draw(d, e), "w_up": draw(e, d, f),
            "w_gate": draw(e, d, f), "w_down": draw(e, f, d)}


def _args(p, k):
    return p["router"], p["w_gate"], p["w_up"], p["w_down"], k


def _close(out, ref, dtype):
    top = float(ref.float().abs().max())
    return float((out.float() - ref.float()).abs().max()) <= ATOL[dtype] * top


def _limit(name):
    (d, f, e, k, cf), _ = WIDTHS[name]
    cfg = _cfg(d, f, e, k, cf)
    return max(t for t in range(1, e + 1) if L.decode_route(
        "cuda", False, False, t, k, e, L.moe_capacity(cfg, t)))


@pytest.mark.parametrize("name", list(WIDTHS))
def test_route_limit_of_each_width(name):
    """The route's limit at each width: t * k <= e and t <= the
    capacity (4 slots at capacity factor 1.25; Granite-4.0-H's 7.2 lets
    every expert take every token, so e / k bounds it)."""
    assert _limit(name) == WIDTHS[name][1]


@pytest.mark.parametrize("name,t,dtype", CASES)
def test_plain_matches_moe_block_local(name, t, dtype):
    """y within the stated tolerance, aux equal, at each width and t."""
    (d, f, e, k, cf), _ = WIDTHS[name]
    if name in BIG:
        e = k * t                    # the experts t tokens can route to
    cfg = _cfg(d, f, e, k, cf)
    p = _params(d, f, e, dtype, seed=t)
    x = torch.randn((1, t, d), generator=torch.Generator().manual_seed(
        100 + t)).to(dtype)
    y, aux = L.moe_block_local(cfg, p, x)
    py, paux = MK.moe_decode_plain(x, *_args(p, k))
    assert py.shape == y.shape and py.dtype == y.dtype
    assert _close(py, y, dtype)
    assert torch.equal(paux, aux)


@pytest.mark.parametrize("t", [1, 2, 3, 4])
def test_plain_matches_the_per_expert_oracle(t):
    """The plain version against ref.py's loop over tokens and experts,
    in fp32 at the smoke width."""
    (d, f, e, k, _), _ = WIDTHS["smoke"]
    p = _params(d, f, e, torch.float32, seed=7)
    x = torch.randn((t, d), generator=torch.Generator().manual_seed(t))
    y, aux = MK.moe_decode_plain(x, *_args(p, k))
    ry, raux = MR.moe_decode_ref(x, *_args(p, k))
    assert _close(y, ry, torch.float32)
    assert abs(float(aux) - float(raux)) < 1e-6


@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
def test_plain_takes_each_activation(activation):
    """GeGLU (gelu, tanh approximation) as the eager path computes it."""
    (d, f, e, k, cf), _ = WIDTHS["smoke"]
    cfg = dataclasses.replace(_cfg(d, f, e, k, cf), activation=activation)
    p = _params(d, f, e, torch.bfloat16, seed=3)
    x = torch.randn((1, 2, d)).to(torch.bfloat16)
    y, _ = L.moe_block_local(cfg, p, x)
    py, _ = MK.moe_decode_plain(x, *_args(p, k), activation=activation)
    assert _close(py, y, torch.bfloat16)


def test_router_ties_go_to_the_lower_expert():
    """Equal router columns give equal probabilities; the picks among them
    are the lowest ids, as moe_gates' stable sort picks."""
    d, e, k = 64, 16, 4
    g = torch.Generator().manual_seed(0)
    router = torch.randn((d, e), generator=g) * 0.02
    router[:, [3, 6, 9, 12, 15]] = router[:, 12:13] + 1.0   # five tied, top
    x = torch.ones((2, d))
    probs, ids, gates = MK.route_plain(x, router, k)
    assert ids.tolist() == [[3, 6, 9, 12]] * 2
    cfg = _cfg(d, 128, e, k, 1.25)
    want = L.moe_gates(cfg, {"router": router}, x)[2]
    assert torch.equal(ids, want.sort(dim=1).values)
    assert torch.allclose(gates, torch.full((2, k), 0.25))


@pytest.mark.parametrize("seed", range(4))
def test_picks_in_ascending_expert_id(seed):
    """Each token's picks come out sorted by expert id, with the gates
    moe_gates gives those experts."""
    d, e, k = 64, 40, 8
    g = torch.Generator().manual_seed(seed)
    router = (torch.randn((d, e), generator=g) * 0.5).to(torch.bfloat16)
    x = torch.randn((4, d), generator=g).to(torch.bfloat16)
    _, ids, gates = MK.route_plain(x, router, k)
    assert torch.equal(ids, ids.sort(dim=1).values)
    cfg = _cfg(d, 128, e, k, 1.25)
    _, vals, idx = L.moe_gates(cfg, {"router": router}, x)
    order = idx.argsort(dim=1)
    assert torch.equal(ids, idx.gather(1, order))
    assert torch.equal(gates, vals.gather(1, order))


def test_aux_equals_moe_block_local():
    """The Switch aux loss of the routed picks, bit for bit, in fp32 and
    over several tokens."""
    (d, f, e, k, cf), _ = WIDTHS["smoke"]
    cfg = _cfg(d, f, e, k, cf)
    p = _params(d, f, e, torch.float32, seed=11)
    x = torch.randn((1, 4, d), generator=torch.Generator().manual_seed(1))
    assert torch.equal(MK.moe_decode_plain(x, *_args(p, k))[1],
                       L.moe_block_local(cfg, p, x)[1])


# (device, dtensor, grad, t, k, e, cap) and whether the route is taken
ROUTES = [
    (("cuda", False, False, 1, 8, 40, 4), True),     # a Granite-3.0 step
    (("cuda", False, False, 1, 10, 72, 4), True),    # a Granite-4.0-H step
    (("cuda", False, False, 5, 8, 40, 4), False),    # t * k > e ...
    (("cuda", False, False, 5, 8, 48, 4), False),    # ... t > cap
    (("cuda", False, False, 6, 8, 40, 8), False),    # t * k > e alone
    (("cuda", False, True, 1, 8, 40, 4), False),     # autograd
    (("cuda", True, False, 1, 8, 40, 4), False),     # a DTensor
    (("cpu", False, False, 1, 8, 40, 4), False),     # the CPU
    (("meta", False, False, 1, 8, 40, 4), False),
]


@pytest.mark.parametrize("facts,taken", ROUTES)
def test_decode_route(facts, taken):
    assert L.decode_route(*facts) is taken


def test_moe_block_keeps_the_eager_dispatch_on_the_cpu():
    """On the CPU moe_block is moe_block_local: nothing launches and the
    outputs are its own."""
    (d, f, e, k, cf), _ = WIDTHS["smoke"]
    cfg = _cfg(d, f, e, k, cf)
    p = _params(d, f, e, torch.bfloat16, seed=5)
    x = torch.randn((1, 1, d)).to(torch.bfloat16)
    n = MK.LAUNCHES["moe_decode"]
    y, aux = L.moe_block(cfg, p, x)
    ly, laux = L.moe_block_local(cfg, p, x)
    assert MK.LAUNCHES["moe_decode"] == n
    assert torch.equal(y, ly) and torch.equal(aux, laux)


def test_ops_takes_the_plain_version_on_the_cpu():
    (d, f, e, k, _), _ = WIDTHS["smoke"]
    p = _params(d, f, e, torch.float32, seed=2)
    x = torch.randn((3, d))
    y, aux = MO.moe_decode(x, *_args(p, k))
    py, paux = MK.moe_decode_plain(x, *_args(p, k))
    assert torch.equal(y, py) and torch.equal(aux, paux)


MOE_ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("arch", MOE_ARCHS + ["granite-4.0-h", "smoke"])
def test_kernel_takes_every_moe_width(arch, dtype):
    """Every MoE config's widths, at one token and at the route's limit
    (``supported`` needs no card)."""
    if arch in MOE_ARCHS:
        c = get_config(arch)
        d, f, e, k = c.d_model, c.d_ff, c.moe.num_experts, \
            c.moe.experts_per_token
    else:
        (d, f, e, k, _), _ = WIDTHS[arch]
    for t in (1, e // k):
        assert MK.supported(t, d, f, e, k, dtype)


@pytest.mark.parametrize("shape,rule", [
    ((1, 100, 512, 40, 8), "multiple of 8"),          # d not whole rows
    ((1, 1536, 500, 40, 8), "multiple of 8"),
    ((1, 1536, 512, 44, 8), "multiple of 8"),         # e
    ((1, 1536, 512, 2048, 8), "at most 1024"),
    ((1, 1536, 512, 128, 17), "top 1 to 16"),       # k past a cluster
    ((1, 1536, 512, 40, 41), "top 1 to 16"),
    ((9000, 1536, 512, 40, 8), "at most 65535"),
    ((1, 1536, 70000, 40, 8), "shared memory"),
])
def test_refusals_name_their_rule(shape, rule):
    with pytest.raises(ValueError, match=rule):
        MK._check_shape(*shape, torch.bfloat16)
    assert not MK.supported(*shape, torch.bfloat16)


def test_launcher_refuses_cpu_tensors():
    """The launcher checks before any build: CPU tensors raise."""
    (d, f, e, k, _), _ = WIDTHS["smoke"]
    p = _params(d, f, e, torch.bfloat16, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        MK.moe_decode(torch.zeros((1, d), dtype=torch.bfloat16),
                      *_args(p, k))


@pytest.mark.parametrize("name,split", [
    ("granite-3.0", 8), ("granite-4.0-h", 4), ("qwen3-moe", 2),
    ("smoke", 2)])
def test_gate_up_split_fills_the_card(name, split):
    """At one bf16 token on 132 SMs, the gate/up kernel's clusters split
    d until the launch has two blocks an SM (Granite-4.0-H: 12 tiles of
    64 columns x 10 experts x 4 = 480 blocks), and no further than d's
    32-row stages (the smoke width's 64 rows: 2)."""
    (d, f, e, k, _), _ = WIDTHS[name]
    assert MK.split_plan(d, f, k, 2, 132) == split


def test_workspace_segments_are_aligned():
    offs, n = MK.workspace(3, 768, 72, 10, 2)
    assert all(o % 256 == 0 for o in offs) and n % 256 == 0
    assert offs[1] - offs[0] >= 4 * 3 * 72 and n - offs[3] >= 2 * 30 * 768
    assert np.all(np.diff(offs) > 0)
