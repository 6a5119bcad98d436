"""The attention kernels' head shapes: every attention-bearing config of
the JAX package's registry is one that both CUDA launchers take
(``supported``, which needs no card), in fp32 and bf16; and at the four
head shapes that the launchers once refused, the plain versions (what the
kernels are held to on the card) agree with the reference's Pallas
kernels in interpret mode on the same numpy-seeded inputs.

Tolerances are those of tests/test_kernels.py: fp32 atol 2e-5, bf16 atol
2e-2 compared in fp32. The kernels themselves run only on the card:
tests/test_torch_cuda.py holds them against the plain versions at these
shapes there.

  PYTHONPATH=src python -m pytest -q tests/test_torch_attention_shapes.py
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import ASSIGNED_ARCHS, get_config  # noqa: E402
from repro.kernels.block_sparse_attn import kernel as JBK  # noqa: E402
from repro.kernels.decode_attn import kernel as JDK  # noqa: E402
from repro.sparse.mask import block_scores, select_blocks  # noqa: E402
from repro_torch.kernels.block_sparse_attn import kernel as BK  # noqa: E402
from repro_torch.kernels.decode_attn import kernel as DK  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
ARCHS = ["sparkv-qwen3-4b", *ASSIGNED_ARCHS]
ATTENTION_ARCHS = [a for a in ARCHS if get_config(a).num_heads > 0]

# (hq, hkv, head_dim) of granite-moe-3b-a800m (g 3), starcoder2-3b (g 12),
# zamba2-2.7b's shared attention (d 80) and gemma-2b (d 256)
NEW_SHAPES = [(24, 8, 64), (24, 2, 128), (32, 32, 80), (8, 1, 256)]


def _heads(arch):
    cfg = get_config(arch)
    return cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim


def test_ten_configs_bear_attention():
    """mamba2-130m is the one config without attention."""
    assert len(ATTENTION_ARCHS) == 10
    assert set(ARCHS) - set(ATTENTION_ARCHS) == {"mamba2-130m"}
    assert {_heads(a) for a in ATTENTION_ARCHS} >= set(NEW_SHAPES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_launchers_take_every_config(arch, dtype):
    hq, hkv, d = _heads(arch)
    assert BK.supported(hq, hkv, d, dtype)
    assert DK.supported(hq, hkv, d, dtype)


@pytest.mark.parametrize("g", range(1, 17))
def test_decode_takes_every_group_to_16(g):
    assert DK.supported(2 * g, 2, 80, torch.bfloat16)
    assert DK.supported(2 * g, 2, 64, torch.float32)


@pytest.mark.parametrize("hq,hkv,d,dtype", [
    (8, 2, 48, torch.float32),        # head size outside the set
    (6, 4, 64, torch.bfloat16),       # hq not a multiple of hkv
    (8, 2, 64, torch.float16),        # dtype outside the set
    (4, 0, 64, torch.float32)])       # no kv head
def test_both_refuse_what_stays_refused(hq, hkv, d, dtype):
    assert not BK.supported(hq, hkv, d, dtype)
    assert not DK.supported(hq, hkv, d, dtype)


def test_decode_refuses_groups_past_16():
    assert not DK.supported(34, 2, 64, torch.float32)
    assert BK.supported(34, 2, 64, torch.float32)


def _arrays(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    arrays = [rng.normal(size=s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(jax_out, torch_out, atol):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32), atol=atol,
                               rtol=0)


@functools.partial(jax.jit, static_argnames=("mass",))
def _jlists(q, k, mass):
    sc = block_scores(q, k, q_block=128, kv_block=128, causal=True)
    return select_blocks(sc, mass=mass, q_block=128, kv_block=128)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hq,hkv,d", NEW_SHAPES)
def test_block_sparse_plain_matches_pallas(hq, hkv, d, dtype):
    """s 256, causal, the reference's lists at the serving mass."""
    s, g = 256, hq // hkv
    (jq, jk, jv), (tq, tk, tv) = _arrays(hq + d, [(hq, s, d), (hkv, s, d),
                                                  (hkv, s, d)], dtype)
    jidx, jcnt = _jlists(jq, jnp.repeat(jk, g, axis=0), 0.98)
    jout = JBK.block_sparse_attention(jq, jk, jv, jidx, jcnt, kv_group=g,
                                      interpret=True)
    tout = BK.block_sparse_attention_plain(
        tq, tk, tv, torch.from_numpy(np.array(jidx)),
        torch.from_numpy(np.array(jcnt)), kv_group=g)
    assert tout.dtype == tq.dtype and tuple(tout.shape) == jout.shape
    _close(jout, tout, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hq,hkv,d", NEW_SHAPES)
def test_decode_plain_matches_pallas(hq, hkv, d, dtype):
    """skv 512, a ragged kv_len that ends inside the second block."""
    b, skv, kv_len = 2, 512, 301
    (jq, jk, jv), (tq, tk, tv) = _arrays(
        hq * d, [(b, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)], dtype)
    jout = JDK.decode_attention(jq, jk, jv, kv_len, kv_block=256,
                                interpret=True)
    tout = DK.decode_attention_plain(tq, tk, tv, kv_len, kv_block=256)
    assert tout.dtype == tq.dtype and tuple(tout.shape) == jout.shape
    _close(jout, tout, DTYPES[dtype][2])


# block sizes of the repo's configs, CLIs and tests: (q_block, kv_block)
BLOCKS = [(16, 16), (32, 32), (48, 48), (96, 96), (128, 32), (32, 128),
          (64, 96), (128, 128)]


@pytest.mark.parametrize("q_block,kv_block", BLOCKS)
def test_block_sparse_takes_blocks_of_16(q_block, kv_block):
    """Any positive multiple of 16 (mma.sync's m16); the query rows a CTA
    takes lie in one q-block."""
    assert BK.supported_blocks(q_block, kv_block)
    for dtype in (torch.float32, torch.bfloat16):
        rows = BK._cta_rows(q_block, dtype)
        assert q_block % rows == 0 and rows % 16 == 0
        assert rows <= (128 if dtype == torch.bfloat16 else 64)


@pytest.mark.parametrize("q_block,kv_block", [
    (24, 32), (32, 24), (8, 8), (0, 64), (64, -64), (100, 128)])
def test_block_sparse_refuses_other_blocks(q_block, kv_block):
    assert not BK.supported_blocks(q_block, kv_block)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_block,kv_block", [(16, 16), (32, 32), (96, 96),
                                              (128, 32)])
def test_block_sparse_plain_matches_pallas_at_block_sizes(q_block, kv_block,
                                                          causal, dtype):
    """hq 4 over hkv 2, d 64, s 192 (384 at a 128-row q-block), the
    reference's lists at mass 0.9."""
    hq, hkv, d, g = 4, 2, 64, 2
    s = 384 if q_block == 128 else 192
    (jq, jk, jv), (tq, tk, tv) = _arrays(q_block + kv_block + causal,
                                         [(hq, s, d), (hkv, s, d),
                                          (hkv, s, d)], dtype)
    sc = block_scores(jq, jnp.repeat(jk, g, axis=0), q_block=q_block,
                      kv_block=kv_block, causal=causal)
    jidx, jcnt = select_blocks(sc, mass=0.9, q_block=q_block,
                               kv_block=kv_block)
    jout = JBK.block_sparse_attention(jq, jk, jv, jidx, jcnt, causal=causal,
                                      q_block=q_block, kv_block=kv_block,
                                      kv_group=g, interpret=True)
    tout = BK.block_sparse_attention_plain(
        tq, tk, tv, torch.from_numpy(np.array(jidx)),
        torch.from_numpy(np.array(jcnt)), causal=causal, q_block=q_block,
        kv_block=kv_block, kv_group=g)
    _close(jout, tout, DTYPES[dtype][2])
