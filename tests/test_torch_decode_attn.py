"""The port's GQA flash-decode (plain version, oracle, dispatch) against
the JAX package's Pallas kernel (interpret mode) and its oracle on the
same inputs. The CUDA kernel is held against the plain version on the
card by tests/test_torch_cuda.py.

Tolerances are those of tests/test_kernels.py: fp32 atol 2e-5, bf16 atol
2e-2 compared in fp32. The port combines per-block partials where the
Pallas kernel carries one running softmax, so the sums are reordered
(fp32 differences measured at most ~3e-7)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.kernels.decode_attn import kernel as JK  # noqa: E402
from repro.kernels.decode_attn import ref as JR  # noqa: E402
from repro_torch.configs import SparKVConfig, get_smoke  # noqa: E402
from repro_torch.kernels.decode_attn import kernel as TK  # noqa: E402
from repro_torch.kernels.decode_attn import ops as TO  # noqa: E402
from repro_torch.kernels.decode_attn import ref as TR  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.serving.engine import SparKVServer  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

# jitted once per shape (op-by-op dispatch compiles every op anew)
_jref = jax.jit(JR.decode_attention_ref, static_argnames=("scale",))


def _inputs(seed, b, hq, hkv, skv, d, dtype):
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((b, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(jax_out, torch_out, atol):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32), atol=atol,
                               rtol=0)


# tests/test_kernels.py:85-90, plus kv_len 0 at the first shape
CASES = [(2, 8, 2, 512, 64, 400, 256), (1, 4, 4, 1024, 128, 1024, 256),
         (3, 16, 2, 768, 128, 700, 128), (2, 8, 1, 512, 256, 333, 512),
         (2, 8, 2, 512, 64, 0, 256)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,skv,d,klen,blk", CASES)
def test_plain_matches_pallas(b, hq, hkv, skv, d, klen, blk, dtype):
    atol = DTYPES[dtype][2]
    (jq, jk, jv), (tq, tk, tv) = _inputs(skv + d + klen, b, hq, hkv, skv, d,
                                         dtype)
    jout = JK.decode_attention(jq, jk, jv, klen, kv_block=blk,
                               interpret=True)
    tout = TK.decode_attention_plain(tq, tk, tv, klen, kv_block=blk)
    assert tout.dtype == tq.dtype and tuple(tout.shape) == jout.shape
    _close(jout, tout, atol)
    jref = _jref(jq, jk, jv, klen)
    tref = TR.decode_attention_ref(tq, tk, tv, klen)
    _close(jref, tref, atol)
    _close(jref, tout, atol)
    if klen == 0:
        assert not tout.any()


def test_plain_does_not_depend_on_kv_block():
    """Ragged kv_len: the split into blocks changes only rounding."""
    _, (tq, tk, tv) = _inputs(9, 2, 8, 2, 1000, 128, "float32")
    outs = [TK.decode_attention_plain(tq, tk, tv, 777, kv_block=blk)
            for blk in (64, 100, 256, 1000)]
    ref = TR.decode_attention_ref(tq, tk, tv, 777)
    for o in outs:
        np.testing.assert_allclose(o.numpy(), ref.numpy(), atol=2e-5,
                                   rtol=0)


@pytest.mark.parametrize("kv_len", [96, 61])
def test_cache_shorter_than_kv_block(kv_len):
    """A 96-token cache under the default 256-key block: the Pallas
    kernel's one block reads past the end of k/v and, in interpret mode,
    returns NaN. The port bounds its loads and matches the oracle."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(7, 1, 4, 2, 96, 32, "float32")
    jout = np.asarray(JK.decode_attention(jq, jk, jv, kv_len,
                                          interpret=True))
    assert np.isnan(jout).any()
    tout = TK.decode_attention_plain(tq, tk, tv, kv_len)
    _close(_jref(jq, jk, jv, kv_len), tout, 2e-5)


@pytest.fixture(scope="module")
def assembled_cache():
    """A smoke port server's cache, assembled on the CPU with every
    chunk streamed (Huffman-decoded and dequantized), as a cachegen
    request assembles it; bf16, as load_context hands it to decode."""
    cfg = get_smoke("sparkv-qwen3-4b", layers=2, d_model=128, heads=4,
                    kv_heads=2, d_ff=128, vocab=256)
    model = build_model(cfg)
    srv = SparKVServer(model, model.init(0, device="cpu"),
                       SparKVConfig(chunk_tokens=32, q_block=16, kv_block=16,
                                    quant_group=32),
                       chunk_tokens=32, device="cpu")
    cid = srv.register_context(
        np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, 96)))
    st = srv.contexts[cid]
    k, v = srv.assemble(st, sorted(st.encoded))
    return k.to(torch.bfloat16), v.to(torch.bfloat16)


@pytest.mark.parametrize("kv_len", [96, 61])
def test_decode_over_assembled_cache(assembled_cache, kv_len):
    """Per layer, one seeded query token over the assembled cache: the
    port's dispatch (plain version on the CPU) against the JAX kernel on
    the same bf16 values, and against the port's own context attention,
    ``layers.flash_attention``, which its decode step runs. kv_block 32
    divides the 96-token cache (see test_cache_shorter_than_kv_block)."""
    ck, cv = assembled_cache
    n_l, b, skv, hkv, d = ck.shape
    rng = np.random.default_rng(kv_len)
    for layer in range(n_l):
        q = rng.normal(size=(b, 4, d)).astype(np.float32)
        tq = torch.from_numpy(q).to(torch.bfloat16)
        out = TO.decode_attention(tq, ck[layer], cv[layer], kv_len,
                                  kv_block=32)
        jout = JK.decode_attention(
            jnp.asarray(q, jnp.bfloat16),
            jnp.asarray(ck[layer].float().numpy(), jnp.bfloat16),
            jnp.asarray(cv[layer].float().numpy(), jnp.bfloat16), kv_len,
            kv_block=32, interpret=True)
        _close(jout, out, 2e-2)
        flash = TL.flash_attention(tq[:, None], ck[layer], cv[layer],
                                   causal=False, kv_len=kv_len)[:, 0]
        np.testing.assert_allclose(out.float().numpy(),
                                   flash.float().numpy(), atol=2e-2, rtol=0)


def test_wrappers_dispatch_on_device():
    """CPU tensors take the plain version and count no launch; the CUDA
    launcher refuses a CPU tensor instead of falling back; kv_len outside
    [0, skv] raises on both."""
    _, (tq, tk, tv) = _inputs(3, 1, 4, 2, 300, 64, "float32")
    before = dict(TK.LAUNCHES)
    out = TO.decode_attention(tq, tk, tv, 250)
    assert out.device.type == "cpu" and TK.LAUNCHES == before
    assert torch.equal(out, TK.decode_attention_plain(tq, tk, tv, 250))
    with pytest.raises(ValueError):
        TK.decode_attention(tq, tk, tv, 250)
    with pytest.raises(ValueError):
        TO.decode_attention(tq, tk, tv, 301)
    assert TK.LAUNCHES == before


# (b, hkv, kv_len): path D's shape and its long cache, ragged and short
# caches, kv_len 0 and 1, many (batch, kv head) pairs, one kv head
PLANS = [(1, 8, 2048), (1, 8, 32000), (1, 8, 1999), (3, 2, 700), (2, 8, 1),
         (2, 8, 63), (2, 8, 64), (2, 8, 65), (1, 1, 1_000_000),
         (64, 8, 4096), (2, 8, 0), (1, 32, 300)]


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("b,hkv,kv_len", PLANS)
def test_split_plan_tiles_the_cache_and_fills_the_card(b, hkv, kv_len, n_sm):
    """The CUDA kernel's splits: whole multiples of 64 keys that tile
    [0, kv_len) exactly (the last may be short, none is empty), at most
    16 (one thread block cluster), and more than half of the splits that
    would bring the grid to two CTAs an SM where kv_len (256 keys a
    split) and the cluster allow."""
    chunk, n_split = TK.split_plan(b, hkv, kv_len, n_sm)
    assert chunk > 0 and chunk % 64 == 0 and 1 <= n_split <= 16
    if kv_len == 0:
        assert n_split == 1
        return
    starts = np.arange(n_split) * chunk
    ends = np.minimum(starts + chunk, kv_len)
    assert starts[0] == 0 and ends[-1] == kv_len
    assert np.all(ends > starts) and np.all(starts[1:] == ends[:-1])
    want = min(16, -(-kv_len // 256), -(-2 * n_sm // (b * hkv)))
    assert 2 * n_split > want


def test_split_plan_at_the_paths_shapes():
    """Path D (Qwen3-4B's 8 kv heads) on an H100's 132 SMs: 8 splits of
    256 keys at kv_len 2048, 16 of 2048 keys at 32,000."""
    assert TK.split_plan(1, 8, 2048, 132) == (256, 8)
    assert TK.split_plan(1, 8, 32000, 132) == (2048, 16)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,skv,d,klen,blk", CASES)
def test_plain_at_the_kernels_split_matches_pallas(b, hq, hkv, skv, d, klen,
                                                   blk, dtype):
    """The plain version blocked as the CUDA kernel splits the cache on an
    H100 (132 SMs) against the Pallas kernel at its own kv_block: the
    split moves only rounding."""
    atol = DTYPES[dtype][2]
    (jq, jk, jv), (tq, tk, tv) = _inputs(skv + d + klen + 1, b, hq, hkv,
                                         skv, d, dtype)
    chunk, _ = TK.split_plan(b, hkv, klen, 132)
    tout = TK.decode_attention_plain(tq, tk, tv, klen, kv_block=chunk)
    jout = JK.decode_attention(jq, jk, jv, klen, kv_block=blk,
                               interpret=True)
    _close(jout, tout, atol)
