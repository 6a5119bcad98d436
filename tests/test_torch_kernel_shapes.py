"""The shapes and types the port's fast kernels do not take, which the
generic kernels take on the card: head sizes outside the fast sets,
blocks that are not multiples of 16, groups past 16 and fp16. The
reference's Pallas kernels in interpret mode against the port's plain
versions (what every kernel is held to on the card), directly and through
the ``ops`` layer on the CPU, on the same numpy-seeded inputs; and
``supported`` / ``supported_blocks`` say the port takes each shape.

Tolerances: fp32 2e-5 (tests/test_kernels.py). fp16 4e-3: both versions
round p to fp16 for the PV product and the output to fp16 on their own,
so they may differ by a step of fp16 or two at the output's magnitude,
which stays under 4 here, where a step is 2^-9 = 1.95e-3 (measured: one
step, 4.9e-4 at magnitudes under 1 and 2.4e-4 for decode). kv_dequant to
fp16 is bit-equal: both round the fp32 fma once to fp16.

The kernels run only on the card: tests/test_torch_cuda.py holds them
against the plain versions at these shapes there.

  PYTHONPATH=src python -m pytest -q tests/test_torch_kernel_shapes.py
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.kernels.block_sparse_attn import kernel as JBK  # noqa: E402
from repro.kernels.decode_attn import kernel as JDK  # noqa: E402
from repro.kernels.kv_dequant import kernel as JKD  # noqa: E402
from repro.sparse.mask import block_scores, select_blocks  # noqa: E402
from repro_torch.kernels import _layout  # noqa: E402
from repro_torch.kernels.block_sparse_attn import kernel as BK  # noqa: E402
from repro_torch.kernels.block_sparse_attn import ops as BO  # noqa: E402
from repro_torch.kernels.decode_attn import kernel as DK  # noqa: E402
from repro_torch.kernels.decode_attn import ops as DO  # noqa: E402
from repro_torch.kernels.decode_attn.ref import \
    decode_attention_ref  # noqa: E402
from repro_torch.kernels.kv_dequant import kernel as KD  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "float16": (jnp.float16, torch.float16, 4e-3)}

# (head size, (q_block, kv_block), group): every head size, block pair and
# group of the cases below at least twice; 120 tokens hold whole blocks
# of 8, 20, 24 and 40
BSA_CASES = [(48, (24, 24), 3), (48, (8, 8), 1), (96, (8, 8), 3),
             (96, (40, 20), 1), (160, (40, 20), 1), (160, (24, 24), 3),
             (512, (8, 8), 1), (512, (40, 20), 3)]
BSA_TOKENS = 120
# (head size, group): decode past the fast kernels' head sizes and groups
DEC_CASES = [(d, g) for d in (48, 96, 512) for g in (20, 32)]


def _arrays(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    arrays = [rng.normal(size=s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(jax_out, torch_out, atol):
    ref = np.asarray(jax_out, np.float32)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(torch_out.float().numpy(), ref, atol=atol,
                               rtol=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,blocks,g", BSA_CASES)
def test_block_sparse_plain_matches_pallas(d, blocks, g, causal, dtype):
    """hq g over one kv head, the reference's lists at mass 0.9; the ops
    layer on the CPU gives the plain version's output."""
    (qb, kb), s = blocks, BSA_TOKENS
    assert BK.supported(g, 1, d, DTYPES[dtype][1])
    assert BK.supported_blocks(qb, kb)
    (jq, jk, jv), (tq, tk, tv) = _arrays(d + qb + g + causal,
                                         [(g, s, d), (1, s, d), (1, s, d)],
                                         dtype)
    sc = block_scores(jq, jnp.repeat(jk, g, axis=0), q_block=qb,
                      kv_block=kb, causal=causal)
    jidx, jcnt = select_blocks(sc, mass=0.9, q_block=qb, kv_block=kb)
    jout = JBK.block_sparse_attention(jq, jk, jv, jidx, jcnt, causal=causal,
                                      q_block=qb, kv_block=kb, kv_group=g,
                                      interpret=True)
    idx, cnt = (torch.from_numpy(np.array(a)) for a in (jidx, jcnt))
    kw = dict(causal=causal, q_block=qb, kv_block=kb, kv_group=g)
    tout = BK.block_sparse_attention_plain(tq, tk, tv, idx, cnt, **kw)
    assert tout.dtype == tq.dtype and tuple(tout.shape) == jout.shape
    _close(jout, tout, DTYPES[dtype][2])
    assert torch.equal(BO.block_sparse_attention(tq, tk, tv, idx, cnt, **kw),
                       tout)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d,g", DEC_CASES)
def test_decode_plain_matches_pallas(d, g, dtype):
    """b 2, one kv head of g query heads, skv 512 in whole blocks of 256
    and kv_len 301 inside the second (the reference gives NaN where the
    last block is partial: test_reference_nan_at_a_partial_last_block);
    the ops layer on the CPU gives the plain version's output."""
    b, skv, kv_len = 2, 512, 301
    assert DK.supported(g, 1, d, DTYPES[dtype][1])
    (jq, jk, jv), (tq, tk, tv) = _arrays(
        d + g, [(b, g, d), (b, skv, 1, d), (b, skv, 1, d)], dtype)
    jout = JDK.decode_attention(jq, jk, jv, kv_len, kv_block=256,
                                interpret=True)
    tout = DK.decode_attention_plain(tq, tk, tv, kv_len, kv_block=256)
    assert tout.dtype == tq.dtype and tuple(tout.shape) == jout.shape
    _close(jout, tout, DTYPES[dtype][2])
    assert torch.equal(DO.decode_attention(tq, tk, tv, kv_len), tout)


def test_reference_nan_at_a_partial_last_block():
    """Pins a fault of the reference, not of the port: with skv 300 the
    last kv block of 256 is partial, and once kv_len reaches into it
    (257) the Pallas kernel reads past k/v and returns NaN in interpret
    mode. The port's plain version answers, as the dense oracle does; at
    kv_len 100, inside the first block, both answer."""
    (jq, jk, jv), (tq, tk, tv) = _arrays(
        7, [(1, 8, 64), (1, 300, 2, 64), (1, 300, 2, 64)], "float32")
    jnan = np.asarray(JDK.decode_attention(jq, jk, jv, 257, kv_block=256,
                                           interpret=True))
    assert np.isnan(jnan).any()
    tout = DK.decode_attention_plain(tq, tk, tv, 257, kv_block=256)
    assert torch.isfinite(tout).all()
    np.testing.assert_allclose(tout.numpy(), decode_attention_ref(
        tq, tk, tv, 257).numpy(), atol=2e-5, rtol=0)
    _close(JDK.decode_attention(jq, jk, jv, 100, kv_block=256,
                                interpret=True),
           DK.decode_attention_plain(tq, tk, tv, 100, kv_block=256), 2e-5)


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("n,width,group", [(37, 128, 64), (16, 128, 8),
                                           (5, 36, 12)])
def test_dequant_to_fp16_bit_equal(n, width, group, mixed):
    """Both Pallas kernels' fp16 output against the plain versions', bit
    for bit; the launchers take fp16 destinations."""
    rng = np.random.default_rng(n + group)
    g = width // group
    bits = rng.choice([3, 4, 5, 8], size=(n, 1)).astype(np.int32)
    codes = (rng.integers(0, 256, size=(n, width)) % (1 << bits)
             ).astype(np.uint8)
    params = rng.uniform(0.01, 4.0, (n, g)).astype(np.float32)
    zeros = rng.normal(size=(n, g)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (codes, params, zeros, bits)]
    if mixed:
        jout = JKD.kv_dequant_mixed(codes, params, zeros, bits, group=group,
                                    interpret=True, out_dtype=jnp.float16)
        tout = KD.kv_dequant_mixed_plain(*t, group=group,
                                         out_dtype=torch.float16)
    else:
        jout = JKD.kv_dequant(codes, params, zeros, group=group,
                              interpret=True, out_dtype=jnp.float16)
        tout = KD.kv_dequant_plain(*t[:3], group=group,
                                   out_dtype=torch.float16)
    assert tout.dtype == torch.float16 and torch.float16 in KD._OUT_DTYPES
    assert np.array_equal(np.asarray(jout).view(np.uint16),
                          tout.numpy().view(np.uint16))


def test_layout_copies_only_what_the_kernels_cannot_read():
    """ops hands the launchers contiguous, 16-byte aligned storage: a
    dense tensor passes as itself, a transposed or misaligned one is
    copied (same values) and counted."""
    copies = {"x": 0}
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    assert _layout.dense(x, copies, "x") is x and copies["x"] == 0
    for view in (x.t(), x.view(-1)[1:33].view(4, 8)):
        y = _layout.dense(view, copies, "x")
        assert y.is_contiguous() and y.data_ptr() % 16 == 0
        assert torch.equal(y, view)
    assert copies["x"] == 2
