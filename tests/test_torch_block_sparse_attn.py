"""The port's block-sparse attention (plain version, oracle, sparse
prefill) against the JAX package's Pallas kernel (interpret mode) and its
oracle on the same inputs and the same block lists. The CUDA kernel is
held against the plain version on the card by tests/test_torch_cuda.py.

Tolerances are those of tests/test_kernels.py: fp32 atol 2e-5 (3e-5 for
its randomized cases), bf16 atol 2e-2 compared in fp32. The port tiles
the same online softmax in the same list order, so fp32 differences are
summation order only (measured at most ~5e-7)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.kernels.block_sparse_attn import kernel as JK  # noqa: E402
from repro.kernels.block_sparse_attn import ops as JO  # noqa: E402
from repro.kernels.block_sparse_attn import ref as JR  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.sparse.mask import block_scores, select_blocks  # noqa: E402
from repro_torch.configs import SparKVConfig, get_smoke  # noqa: E402
from repro_torch.convert import convert_params  # noqa: E402
from repro_torch.kernels.block_sparse_attn import kernel as TK  # noqa: E402
from repro_torch.kernels.block_sparse_attn import ops as TO  # noqa: E402
from repro_torch.kernels.block_sparse_attn import ref as TR  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402

# jitted once per shape: op-by-op dispatch of the reference's oracle and
# mask would compile every op anew for each case's shapes
_jref = jax.jit(JR.block_sparse_attention_ref,
                static_argnames=("causal", "q_block", "kv_block", "scale"))
_jprefill = jax.jit(JO.sparse_prefill_attention,
                    static_argnames=("mass", "q_block", "kv_block", "causal",
                                     "use_ref", "interpret"))

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    arrays = [rng.normal(size=s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@functools.partial(jax.jit, static_argnames=("mass", "causal"))
def _jlists(q, k, mass, causal):
    sc = block_scores(q, k, q_block=128, kv_block=128, causal=causal)
    return select_blocks(sc, mass=mass, q_block=128, kv_block=128)


def _lists(q, k, mass, causal=True):
    """The reference's block lists (tests/test_torch_mask.py holds the
    port's lists equal to them) on both sides."""
    idx, cnt = _jlists(q, k, mass, causal)
    return (idx, cnt), (torch.from_numpy(np.array(idx)),
                        torch.from_numpy(np.array(cnt)))


def _close(jax_out, torch_out, atol):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32), atol=atol,
                               rtol=0)


def _check_case(bh, s, d, dtype, g, mass, causal, atol):
    """Pallas kernel vs plain version; reference oracle vs port oracle."""
    jx, tx = _inputs(bh * s + d, [(bh * g, s, d), (bh, s, d), (bh, s, d)],
                     dtype)
    jq, jk, jv = jx
    tq, tk, tv = tx
    jkr, jvr = jnp.repeat(jk, g, axis=0), jnp.repeat(jv, g, axis=0)
    (jidx, jcnt), (tidx, tcnt) = _lists(jq, jkr, mass, causal)
    jout = JK.block_sparse_attention(jq, jk, jv, jidx, jcnt, causal=causal,
                                     kv_group=g, interpret=True)
    tout = TK.block_sparse_attention_plain(tq, tk, tv, tidx, tcnt,
                                           causal=causal, kv_group=g)
    assert tout.dtype == tq.dtype and tuple(tout.shape) == jout.shape
    _close(jout, tout, atol)
    jref = _jref(jq, jkr, jvr, jidx, jcnt, causal=causal)
    tref = TR.block_sparse_attention_ref(
        tq, tk.repeat_interleave(g, 0), tv.repeat_interleave(g, 0), tidx,
        tcnt, causal=causal)
    _close(jref, tref, atol)
    _close(jref, tout, atol)


# tests/test_kernels.py:30-35 (test_block_sparse_attention_vs_ref)
@pytest.mark.parametrize("bh,s,d,dtype", [
    (4, 512, 64, "float32"), (2, 1024, 128, "float32"),
    (2, 256, 128, "bfloat16"), (6, 384, 64, "float32")])
def test_plain_matches_pallas(bh, s, d, dtype):
    _check_case(bh, s, d, dtype, 1, 0.9, True, DTYPES[dtype][2])


# tests/test_kernels.py:51-63 (GQA: q row bh reads kv row bh // g)
@pytest.mark.parametrize("g", [2, 4, 8])
def test_plain_matches_pallas_gqa(g):
    _check_case(2, 256, 64, "float32", g, 0.95, True, 2e-5)


# tests/test_kernels.py:239-253: its randomized (bh, s, causal) cases at
# mass 0.85, as a fixed spread over the same ranges
@pytest.mark.parametrize("bh,s,causal", [
    (1, 128, True), (2, 256, False), (3, 384, True), (1, 512, False),
    (2, 512, True), (3, 128, False)])
def test_plain_matches_pallas_randomized_cases(bh, s, causal):
    _check_case(bh, s, 64, "float32", 1, 0.85, causal, 3e-5)


def test_full_list_equals_dense_causal():
    """tests/test_kernels.py:66-82: every causal block listed (idx =
    arange, cnt = qb + 1) gives dense causal attention, on both sides."""
    bh, s, d = 2, 256, 64
    (jq, jk, jv), (tq, tk, tv) = _inputs(5, [(bh, s, d)] * 3, "float32")
    n_b = s // 128
    idx = np.broadcast_to(np.arange(n_b), (bh, n_b, n_b)).astype(np.int32)
    cnt = np.broadcast_to(np.arange(1, n_b + 1), (bh, n_b)).astype(np.int32)
    jout = JK.block_sparse_attention(jq, jk, jv, jnp.asarray(idx),
                                     jnp.asarray(cnt), interpret=True)
    tout = TK.block_sparse_attention_plain(tq, tk, tv,
                                           torch.from_numpy(idx.copy()),
                                           torch.from_numpy(cnt.copy()))
    sc = torch.einsum("bqd,bkd->bqk", tq, tk) * d ** -0.5
    sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                        -torch.inf)
    dense = torch.einsum("bqk,bkd->bqd", torch.softmax(sc, -1), tv)
    _close(jout, tout, 2e-5)
    np.testing.assert_allclose(tout.numpy(), dense.numpy(), atol=2e-5)


def test_block_mask_dense_matches_reference():
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 6, size=(3, 4, 6)).astype(np.int32)
    cnt = rng.integers(0, 7, size=(3, 4)).astype(np.int32)
    j = JR.block_mask_dense(jnp.asarray(idx), jnp.asarray(cnt), 4, 6)
    t = TR.block_mask_dense(torch.from_numpy(idx), torch.from_numpy(cnt),
                            4, 6)
    assert np.array_equal(np.asarray(j), t.numpy())


def test_empty_rows_output_zero():
    """A (head, q-block) row with no listed block, or whose only block the
    causal mask hides, outputs 0 on both sides."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, [(1, 256, 64)] * 3, "float32")
    idx = np.array([[[1, 0], [1, 0]]], np.int32)     # q-block 0 -> kv 1
    cnt = np.array([[1, 0]], np.int32)
    jout = JK.block_sparse_attention(jq, jk, jv, jnp.asarray(idx),
                                     jnp.asarray(cnt), interpret=True)
    tout = TK.block_sparse_attention_plain(tq, tk, tv, torch.from_numpy(idx),
                                           torch.from_numpy(cnt))
    assert not tout.any()
    _close(jout, tout, 0.0)


@pytest.mark.parametrize("use_ref", [False, True])
def test_sparse_prefill_matches_reference(use_ref):
    """b 1, s 512, hq 4, hkv 2, d 64 in fp32: the same block counts, bit
    for bit, and outputs within 2e-5."""
    shape_q, shape_kv = (1, 512, 4, 64), (1, 512, 2, 64)
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        11, [shape_q, shape_kv, shape_kv], "float32")
    jout, jcnt = _jprefill(jq, jk, jv, use_ref=use_ref, interpret=True)
    tout, tcnt = TO.sparse_prefill_attention(tq, tk, tv, use_ref=use_ref)
    assert tcnt.dtype == torch.int32 and tuple(tout.shape) == shape_q
    assert np.array_equal(np.asarray(jcnt), tcnt.numpy())
    _close(jout, tout, 2e-5)


def test_slice_qkv_through_sparse_prefill():
    """The slice as a whole, on a smoke config with the reference's
    weights converted: layer 0's norm and q/k/v projection with RoPE on
    each side, then each side's sparse_prefill_attention at the serving
    mass. fp32 weights, so the comparison is of algorithms."""
    arch = dict(layers=2, d_model=256, heads=4, kv_heads=2, d_ff=128,
                vocab=256)
    jcfg = jget_smoke("sparkv-qwen3-4b", **arch)
    tcfg = get_smoke("sparkv-qwen3-4b", **arch)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32),
                           jbuild(jcfg).init(jax.random.PRNGKey(0)))
    tparams = convert_params(jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (1, 512))
    pos = np.arange(512)

    jbp = jax.tree.map(lambda a: a[0], jparams["blocks"])
    jh = JL.apply_norm(jcfg, jparams["emb"][jnp.asarray(tokens)],
                       jbp["attn_norm"])
    jq, jk, jv = JL.attention_qkv(jcfg, jbp["attn"], jh, jnp.asarray(pos))
    tbp = layer_params(tparams["blocks"], 0)
    th = TL.apply_norm(tcfg, tparams["emb"][torch.from_numpy(tokens)],
                       tbp["attn_norm"])
    tq, tk, tv = TL.attention_qkv(tcfg, tbp["attn"], th,
                                  torch.from_numpy(pos))
    assert tuple(tq.shape) == (1, 512, 4, 64) and tk.shape[2] == 2
    mass = SparKVConfig().attention_mass
    jout, jcnt = _jprefill(jq, jk, jv, mass=mass, interpret=True)
    tout, tcnt = TO.sparse_prefill_attention(tq, tk, tv, mass=mass)
    assert np.array_equal(np.asarray(jcnt), tcnt.numpy())
    _close(jout, tout, 2e-5)


def test_wrappers_dispatch_on_device():
    """CPU tensors take the plain version and count no launch; the CUDA
    launcher refuses a CPU tensor instead of falling back."""
    (_, _, _), (tq, tk, tv) = _inputs(3, [(2, 256, 64)] * 3, "float32")
    idx = torch.zeros((2, 2, 2), dtype=torch.int32)
    cnt = torch.ones((2, 2), dtype=torch.int32)
    before = dict(TK.LAUNCHES)
    out = TO.block_sparse_attention(tq, tk, tv, idx, cnt)
    assert out.device.type == "cpu" and TK.LAUNCHES == before
    assert torch.equal(out, TK.block_sparse_attention_plain(tq, tk, tv, idx,
                                                            cnt))
    with pytest.raises(ValueError):
        TK.block_sparse_attention(tq, tk, tv, idx, cnt)
    assert TK.LAUNCHES == before


def test_listed_blocks_are_what_the_kernel_walks():
    """listed_blocks keeps the entries before the count that lie inside
    k/v, in list order; the plain version on them equals the Pallas
    kernel on lists that hold only those entries."""
    idx = torch.tensor([[[3, -1, 1, 4, 0], [2, 2, 9, 0, 1]]],
                       dtype=torch.int32)
    cnt = torch.tensor([[4, 9]], dtype=torch.int32)
    got, n = TK.listed_blocks(idx, cnt, 4)
    assert n.tolist() == [[2, 4]]
    assert got[0, 0, :2].tolist() == [3, 1]
    assert got[0, 1, :4].tolist() == [2, 2, 0, 1]
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        11, [(1, 256, 64), (1, 512, 64), (1, 512, 64)], "float32")
    idx = torch.tensor([[[0, 7, 1, 2], [3, -2, 2, 0]]], dtype=torch.int32)
    cnt = torch.tensor([[3, 4]], dtype=torch.int32)
    got, n = TK.listed_blocks(idx, cnt, 4)
    plain = TK.block_sparse_attention_plain(tq, tk, tv, got, n,
                                            causal=False)
    jout = JK.block_sparse_attention(
        jq, jk, jv, jnp.asarray([[[0, 1, 0], [3, 2, 0]]], jnp.int32),
        jnp.asarray([[2, 3]], jnp.int32), causal=False, interpret=True)
    _close(jout, plain, 2e-5)
