"""The host side of the generic attention kernels, without a card: the
generic decode split (``decode_attn/kernel.py::split_plan_generic``), its
workspace, the tiers and shared memory of ``kernels/_generic.py`` (the
geometry ``csrc/generic_attn.cuh`` launches with), and the shape test that
routes every attention-bearing config to the fast kernels and chip_smoke
path O's shapes to the generic ones.

The kernels run only on the card: tests/test_torch_cuda.py holds them
against the plain versions there.

  PYTHONPATH=src python -m pytest -q tests/test_torch_generic_plan.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ASSIGNED_ARCHS, get_config  # noqa: E402
from repro_torch.kernels import _generic as G  # noqa: E402
from repro_torch.kernels.block_sparse_attn import kernel as BK  # noqa: E402
from repro_torch.kernels.decode_attn import kernel as DK  # noqa: E402

DTYPES = [torch.float32, torch.bfloat16, torch.float16]

# (b, hkv, g, kv_len): path O's decode shape and its ragged lengths,
# Falcon-7B's 71 heads over one, kv_len 0 and 1, short and long caches,
# many (batch, kv head) pairs
PLANS = [(1, 2, 20, 32000), (1, 2, 20, 31999), (1, 2, 20, 12345),
         (2, 1, 71, 1999), (1, 1, 48, 100_000), (2, 1, 2, 0),
         (2, 1, 2, 1), (2, 8, 17, 63), (64, 8, 20, 4096),
         (70000, 1, 2, 33), (1, 32, 3, 2048)]


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hkv,g,kv_len", PLANS)
def test_generic_split_tiles_the_cache(b, hkv, g, kv_len, dtype, n_sm):
    """Whole multiples of 64 keys that tile [0, kv_len) with no empty
    split, at least 128 keys a split unless kv_len is shorter, and enough
    splits to give the launch a CTA an SM where kv_len allows."""
    items = b * hkv * DK.head_chunks(g, dtype)
    chunk, n_split = DK.split_plan_generic(items, kv_len, n_sm)
    assert chunk > 0 and chunk % 64 == 0 and n_split >= 1
    if kv_len == 0:
        assert n_split == 1
        return
    starts = np.arange(n_split) * chunk
    ends = np.minimum(starts + chunk, kv_len)
    assert starts[0] == 0 and ends[-1] == kv_len
    assert np.all(ends > starts) and np.all(starts[1:] == ends[:-1])
    assert chunk >= min(128, -(-kv_len // 64) * 64)
    if kv_len >= 128 * n_sm:
        assert items * n_split >= n_sm


def test_generic_split_fills_the_card_at_path_o():
    """Path O's decode (1 batch, 2 kv heads of 20 query heads, kv_len
    32,000) on an H100's 132 SMs: 125 splits of 256 keys, 250 CTAs, where
    the fast plan's clusters would give 32."""
    for dtype in DTYPES:
        items = 2 * DK.head_chunks(20, dtype)
        assert items == 2
        assert DK.split_plan_generic(items, 32000, 132) == (256, 125)
    assert DK.split_plan(1, 2, 32000, 132)[1] * 2 == 32


@pytest.mark.parametrize("g,dtype,chunks", [
    (20, torch.bfloat16, 1), (64, torch.bfloat16, 1),
    (71, torch.bfloat16, 2), (71, torch.float32, 3),
    (32, torch.float32, 1), (48, torch.float16, 1)])
def test_head_chunks(g, dtype, chunks):
    """A split's CTAs: up to 64 query heads a CTA on the tensor cores, 32
    in fp32."""
    assert DK.head_chunks(g, dtype) == chunks


# d -> (tier, O's column chunks)
TIERS = {1: (64, 1), 33: (64, 1), 96: (128, 1), 160: (256, 1),
         256: (256, 1), 264: (256, 2), 2048: (256, 8), 4096: (256, 16)}


@pytest.mark.parametrize("d", sorted(TIERS))
def test_tier_and_workspace(d):
    """The padded-width tier of a head size, the CTAs its O's columns
    take, and the decode workspace: (m, l) and d floats of O for every
    query head and split, none for one split."""
    assert (G.tier(d), G.col_chunks(d)) == TIERS[d]
    assert G.width(d, torch.bfloat16) == -(-d // 16) * 16
    assert G.width(d, torch.float32) == -(-d // 4) * 4
    assert DK.workspace_floats(1, 40, d, 1) == 0
    assert DK.workspace_floats(1, 40, d, 125) == 40 * 125 * (d + 2)
    assert DK.workspace_floats(3, 8, d, 2) == 3 * 8 * 2 * (d + 2)


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_head_size_fits_a_cta(dtype, decode):
    """Every head size the launchers take (1 to 4096, decode 2048) asks,
    at 32 and at 64 rows a CTA, for shared memory a CTA can hold. At d 96,
    path O's block-sparse (24 rows, two stages) leaves room for three CTAs
    an SM; its decode (20 rows, three stages on the tensor cores) for two,
    which hold its 250 CTAs on 132 SMs."""
    for rows in (24, 64):
        sizes = [G.smem_bytes(d, dtype, rows, decode)
                 for d in range(1, 2049 if decode else 4097)]
        assert max(sizes) <= G.MAX_SMEM
    rows = 20 if decode else 24
    per_sm = 228 * 1024 // (G.smem_bytes(96, dtype, rows, decode) + 1024)
    assert per_sm == (2 if decode and dtype != torch.float32 else 3)
    assert G.stages(96, dtype, decode) == (3 if per_sm == 2 else 2)


@pytest.mark.parametrize("rows,groups,cta", [
    (1, 1, 32), (16, 1, 32), (17, 2, 32), (24, 2, 32), (32, 2, 32),
    (33, 4, 64), (64, 4, 64), (71, 4, 64)])
def test_tensor_core_rows_and_groups(rows, groups, cta):
    """On the tensor cores a CTA takes two m16 tiles of rows, its 4 warps
    sharing one tile's keys (1 group of 16 each) or splitting two tiles'
    (2 groups), or four tiles, a warp each (4 groups)."""
    assert G.tc_groups(rows) == groups
    assert G.cta_rows(torch.bfloat16, rows) == cta
    assert G.cta_rows(torch.float32, rows) == 32


ATTENTION_ARCHS = [a for a in ["sparkv-qwen3-4b", *ASSIGNED_ARCHS]
                   if get_config(a).num_heads > 0]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_configs_take_the_fast_kernels(arch, dtype):
    """The shape test routes every attention-bearing config to the fast
    kernels: block-sparse at 128-row blocks over 2048 tokens (path K's),
    decode at batch 1."""
    cfg = get_config(arch)
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    assert BK._fast(hq, hkv, 2048, d, dtype, 128, 128)
    assert DK._fast(1, hq, hkv, d, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_path_o_shapes_take_the_generic_kernels(dtype):
    """Path O's full-width shapes stay on the generic route, so that its
    numbers measure the generic kernels: block-sparse at 32/8 heads of 96
    in (24, 24) blocks over 2040 tokens, decode at 40/2 heads of 96."""
    assert not BK._fast(32, 8, 2040, 96, dtype, 24, 24)
    assert BK.supported(32, 8, 96, dtype) and BK.supported_blocks(24, 24)
    assert not DK._fast(1, 40, 2, 96, dtype)
    assert DK.supported(40, 2, 96, dtype)
    assert len(ATTENTION_ARCHS) == 10
