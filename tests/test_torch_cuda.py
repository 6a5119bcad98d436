"""The port on the card: each CUDA kernel against its plain version, and
the serving path through the kernels. Imports no JAX, so it runs where
only PyTorch is installed; without a card every case skips.

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.compression.quantize import quantize  # noqa: E402
from repro_torch.configs import SparKVConfig, get_smoke  # noqa: E402
from repro_torch.kernels.block_sparse_attn import kernel as BK  # noqa: E402
from repro_torch.kernels.block_sparse_attn.ops import \
    block_lists  # noqa: E402
from repro_torch.kernels.decode_attn import kernel as DK  # noqa: E402
from repro_torch.kernels.kv_dequant import kernel as K  # noqa: E402
from repro_torch.kernels.kv_dequant import ops as KO  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import SparKVServer  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, width, group, seed, device):
    rng = np.random.default_rng(seed)
    g = width // group
    bits = rng.choice([3, 4, 5, 6, 8], size=(n, 1)).astype(np.int32)
    codes = (rng.integers(0, 256, size=(n, width)) %
             (1 << bits)).astype(np.uint8)
    arrays = (codes, rng.uniform(0.01, 4.0, (n, g)).astype(np.float32),
              rng.normal(size=(n, g)).astype(np.float32), bits)
    return [torch.from_numpy(a).to(device) for a in arrays]


def _same_bits(a, b):
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return torch.equal(a.view(view), b.view(view))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,width,group", [(2048, 512, 64), (37, 128, 64),
                                           (129, 128, 32), (5, 192, 64)])
def test_kernels_bit_equal_to_plain(cuda, n, width, group, dtype):
    """Bit-equal (tolerance 0): both round code * step + zero once."""
    codes, params, zeros, bits = _inputs(n, width, group, n, cuda)
    out = K.kv_dequant(codes, params, zeros, group=group, out_dtype=dtype)
    plain = K.kv_dequant_plain(codes, params, zeros, group=group,
                               out_dtype=dtype)
    assert _same_bits(out, plain)
    out = K.kv_dequant_mixed(codes, params, zeros, bits, group=group,
                             out_dtype=dtype)
    plain = K.kv_dequant_mixed_plain(codes, params, zeros, bits,
                                     group=group, out_dtype=dtype)
    assert _same_bits(out, plain)


def test_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    codes, params, zeros, bits = _inputs(8, 128, 64, 0, cuda)
    with pytest.raises(ValueError):        # group not a multiple of 16
        K.kv_dequant(codes, params, zeros, group=8)
    with pytest.raises(ValueError):        # non-contiguous parameters
        K.kv_dequant(codes, params.t().contiguous().t(), zeros, group=64)
    with pytest.raises(ValueError):        # misaligned codes
        K.kv_dequant(codes.reshape(-1)[1:129].reshape(1, 128), params[:1],
                     zeros[:1], group=64)


# the batches of tests/test_torch_kv_dequant.py: (group, mixed form,
# entries of (cache, slot, values, bits)) into K and V caches of 6 slots of
# 4096 values
BATCHES = [
    (64, False, [("k", 0, 1000, 5), ("v", 0, 1000, 5), ("k", 2, 33, 5),
                 ("v", 3, 64, 5), ("k", 4, 17, 5), ("v", 5, 4096, 5),
                 ("k", 5, 1, 5)]),
    (32, False, [("k", 1, 100, 4), ("v", 1, 4096, 4), ("v", 4, 31, 4)]),
    (64, True, [("k", 0, 1000, 3), ("v", 0, 1000, 8), ("k", 1, 4096, 5),
                ("v", 2, 65, 4), ("k", 3, 7, 6), ("v", 4, 4096, 5)]),
    (32, True, [("k", 0, 48, 4), ("k", 2, 4000, 6), ("v", 2, 4000, 5),
                ("v", 5, 129, 3)]),
    (64, True, [("v", 1, 4096, 5), ("k", 3, 333, 5)]),
]
SENTINEL = -7.25


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,mixed,entries", BATCHES)
def test_batch_kernel_bit_equal_to_plain(cuda, group, mixed, entries,
                                         dtype):
    """One launch over a staged batch writes, bit for bit, what the plain
    version writes into the K and V caches, and nothing elsewhere."""
    rng = np.random.default_rng(group + len(entries))
    qts = [quantize((3 * rng.normal(size=n)).astype(np.float32), b, group)
           for _, _, n, b in entries]
    caches = []
    for run in (K.dequant_batch, K.dequant_batch_plain):
        cache = {c: torch.full((6, 4096), SENTINEL, dtype=dtype,
                               device=cuda) for c in "kv"}
        b = KO.stage(qts, [cache[c][slot] for c, slot, _, _ in entries],
                     mixed=mixed)
        before = dict(K.LAUNCHES)
        run(b)
        launched = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
        if run is K.dequant_batch:
            assert launched == {"kv_dequant": int(not mixed),
                                "kv_dequant_mixed": int(mixed)}
        else:
            assert not any(launched.values())
        caches.append(cache)
    torch.cuda.synchronize()
    for c in "kv":
        assert _same_bits(caches[0][c], caches[1][c])
        written = torch.zeros((6, 4096), dtype=torch.bool, device=cuda)
        for name, slot, n, _ in entries:
            if name == c:
                written[slot, :n] = True
        assert bool((caches[0][c][~written] == SENTINEL).all())


def test_batch_launcher_refuses_what_the_kernel_cannot_take(cuda):
    rng = np.random.default_rng(0)
    qt = quantize(rng.normal(size=100).astype(np.float32), 5, 64)
    flat = torch.zeros(1024, device=cuda)
    with pytest.raises(ValueError):        # destination not 16-byte aligned
        K.dequant_batch(KO.stage([qt], [flat[1:101]], mixed=False))
    with pytest.raises(ValueError):        # destinations overlap
        K.dequant_batch(KO.stage([qt, qt], [flat[:100], flat[64:164]],
                                 mixed=False))
    with pytest.raises(ValueError):        # destination too small
        K.dequant_batch(KO.stage([qt], [flat[:96]], mixed=False))
    with pytest.raises(ValueError):        # mixed destination dtypes
        K.dequant_batch(KO.stage([qt, qt], [flat[:100], torch.zeros(
            100, dtype=torch.bfloat16, device=cuda)], mixed=False))


@pytest.mark.parametrize("sched", ["uniform", "attention"])
def test_serving_on_card_goes_through_kernels(cuda, sched):
    """A small server on the card dequantizes every streamed chunk in one
    launch (uniform or mixed form), and assembles exactly the cache a CPU
    server assembles from the same stored context with the plain
    versions."""
    cfg = get_smoke("sparkv-qwen3-4b", layers=3, d_model=64, heads=4,
                    d_ff=128, vocab=256)
    spcfg = SparKVConfig(chunk_tokens=32, q_block=16, kv_block=16,
                         quant_group=32, alloc_schedule=sched)
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    srv = SparKVServer(model, params, spcfg, chunk_tokens=32, device=cuda)
    cid = srv.register_context(
        np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, 96)))
    K.reset_launches()
    cache, res = srv.load_context(cid, policy="cachegen")
    n = res.engine.n_streamed
    assert n == srv.contexts[cid].n_chunks
    if sched == "uniform":
        assert K.LAUNCHES == {"kv_dequant": 1, "kv_dequant_mixed": 0}
    else:
        assert K.LAUNCHES == {"kv_dequant": 0, "kv_dequant_mixed": 1}
    st = srv.contexts[cid]
    streamed = sorted(res.engine.streamed_set)
    gk, gv = srv.assemble(st, streamed)

    cpu = SparKVServer(model, params, spcfg, chunk_tokens=32, device="cpu")
    cst = type(st)(tokens=st.tokens, exact_k=st.exact_k.cpu(),
                   exact_v=st.exact_v.cpu(), encoded=st.encoded, wl=st.wl,
                   n_chunks=st.n_chunks)
    ck, cv = cpu.assemble(cst, streamed)
    assert _same_bits(gk.cpu(), ck) and _same_bits(gv.cpu(), cv)
    assert _same_bits(cache["k"].cpu(), ck.to(torch.bfloat16))


# attention tolerances of tests/test_kernels.py, compared in fp32, scaled
# down where the reference's largest magnitude is under 1 (long random
# caches average their values towards 0)
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _close(out, ref, dtype):
    ref = ref.float()
    tol = ATOL[dtype] * min(1.0, float(ref.abs().max()))
    return float((out.float() - ref).abs().max()) <= tol


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh_kv,g,s,d,causal,mass", [
    (4, 1, 512, 64, True, 0.9), (2, 1, 1024, 128, True, 0.9),
    (2, 2, 256, 64, True, 0.95), (2, 4, 384, 128, True, 0.95),
    (1, 8, 256, 64, True, 0.95), (2, 1, 512, 64, False, 0.85),
    (1, 4, 384, 128, False, 0.98)])
def test_block_sparse_kernel_matches_plain(cuda, bh_kv, g, s, d, causal,
                                           mass, dtype):
    gen = torch.Generator(device=cuda).manual_seed(s + d + g)
    q = _randn(gen, (bh_kv * g, s, d), dtype, cuda)
    k = _randn(gen, (bh_kv, s, d), dtype, cuda)
    v = _randn(gen, (bh_kv, s, d), dtype, cuda)
    idx, cnt = block_lists(q, k, g, mass=mass, q_block=128, kv_block=128,
                           causal=causal)
    before = BK.LAUNCHES["block_sparse_attention"]
    out = BK.block_sparse_attention(q, k, v, idx, cnt, causal=causal,
                                    kv_group=g)
    assert BK.LAUNCHES["block_sparse_attention"] == before + 1
    plain = BK.block_sparse_attention_plain(q, k, v, idx, cnt,
                                            causal=causal, kv_group=g)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    assert _close(out, plain, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,skv,d,kv_len,blk", [
    (2, 8, 2, 512, 64, 400, 256), (1, 4, 4, 1024, 128, 1024, 256),
    (3, 16, 2, 768, 128, 700, 128), (2, 8, 1, 512, 256, 333, 512),
    (2, 8, 2, 512, 64, 0, 256), (1, 32, 8, 2048, 128, 1999, 256),
    (1, 32, 8, 96, 128, 61, 256), (2, 8, 8, 300, 32, 1, 64)])
def test_decode_kernel_matches_plain(cuda, b, hq, hkv, skv, d, kv_len, blk,
                                     dtype):
    gen = torch.Generator(device=cuda).manual_seed(skv + kv_len)
    q = _randn(gen, (b, hq, d), dtype, cuda)
    k = _randn(gen, (b, skv, hkv, d), dtype, cuda)
    v = _randn(gen, (b, skv, hkv, d), dtype, cuda)
    before = DK.LAUNCHES["decode_attention"]
    out = DK.decode_attention(q, k, v, kv_len, kv_block=blk)
    # one launch a call: the splits are combined in the same launch
    assert DK.LAUNCHES["decode_attention"] == before + 1
    plain = DK.decode_attention_plain(q, k, v, kv_len, kv_block=blk)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    if kv_len == 0:
        assert not out.any()
    else:
        assert _close(out, plain, dtype)


def _lists_with_holes(gen, bh, n_qb, n_kb, device):
    """Random lists that also hold entries outside [0, n_kb), rows with
    cnt 0 and counts past the list's end, and the lists the kernel walks
    in them."""
    nnz = n_kb + 2
    idx = torch.randint(-1, n_kb + 1, (bh, n_qb, nnz), generator=gen,
                        device=device, dtype=torch.int32)
    cnt = torch.randint(0, nnz + 3, (bh, n_qb), generator=gen, device=device,
                        dtype=torch.int32)
    cnt[0, 0] = 0
    cnt[-1, -1] = nnz + 2
    return (idx, cnt, *BK.listed_blocks(idx, cnt, n_kb))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh_kv,g,s,d,q_block,kv_block", [
    (2, 1, 512, 64, 64, 64), (1, 4, 512, 128, 64, 256),
    (1, 8, 512, 64, 256, 64), (2, 4, 512, 128, 256, 256),
    (1, 1, 768, 128, 128, 64), (1, 8, 256, 128, 128, 128)])
def test_block_sparse_bf16_tensor_cores_at_tile_edges(cuda, bh_kv, g, s, d,
                                                      q_block, kv_block,
                                                      causal):
    """The bf16 tensor-core kernel (64 query rows a CTA where q_block is
    64, else 128) against the plain version on the lists it reads, with
    out-of-range entries, empty rows and counts past the list."""
    gen = torch.Generator(device=cuda).manual_seed(s + d + g + q_block)
    q = _randn(gen, (bh_kv * g, s, d), torch.bfloat16, cuda)
    k = _randn(gen, (bh_kv, s, d), torch.bfloat16, cuda)
    v = _randn(gen, (bh_kv, s, d), torch.bfloat16, cuda)
    idx, cnt, seen, seen_cnt = _lists_with_holes(
        gen, bh_kv * g, s // q_block, s // kv_block, cuda)
    before = BK.LAUNCHES["block_sparse_attention"]
    out = BK.block_sparse_attention(q, k, v, idx, cnt, causal=causal,
                                    q_block=q_block, kv_block=kv_block,
                                    kv_group=g)
    assert BK.LAUNCHES["block_sparse_attention"] == before + 1
    plain = BK.block_sparse_attention_plain(q, k, v, seen, seen_cnt,
                                            causal=causal, q_block=q_block,
                                            kv_block=kv_block, kv_group=g)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    assert _close(out, plain, torch.bfloat16)
    assert not out[0, :q_block].any()          # cnt 0: the row sees no key


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,skv,d,kv_len", [
    (3, 16, 2, 1024, 128, 1), (3, 16, 2, 1024, 128, 63),
    (3, 16, 2, 1024, 128, 64), (3, 16, 2, 1024, 128, 65),
    (1, 32, 8, 4096, 128, 4095), (2, 8, 1, 640, 256, 577),
    (1, 16, 1, 2000, 32, 1999), (4, 4, 4, 130, 64, 129)])
def test_decode_at_split_edges_one_launch(cuda, b, hq, hkv, skv, d, kv_len,
                                          dtype):
    """kv_len 1, under, at and past one 64-key stage, ragged last splits;
    one launch a call, and a second call on the same stream gives the
    same output."""
    gen = torch.Generator(device=cuda).manual_seed(skv + kv_len + d)
    q = _randn(gen, (b, hq, d), dtype, cuda)
    k = _randn(gen, (b, skv, hkv, d), dtype, cuda)
    v = _randn(gen, (b, skv, hkv, d), dtype, cuda)
    before = DK.LAUNCHES["decode_attention"]
    out = DK.decode_attention(q, k, v, kv_len)
    again = DK.decode_attention(q, k, v, kv_len)
    assert DK.LAUNCHES["decode_attention"] == before + 2
    plain = DK.decode_attention_plain(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert _close(out, plain, dtype)
    assert torch.equal(out, again)


def test_decode_consecutive_calls_with_other_splits(cuda):
    """Consecutive calls with other split counts on one stream: each
    call's combine sees only its own splits."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    k = _randn(gen, (2, 3000, 4, 64), torch.bfloat16, cuda)
    v = _randn(gen, (2, 3000, 4, 64), torch.bfloat16, cuda)
    q = _randn(gen, (2, 16, 64), torch.bfloat16, cuda)
    outs = [DK.decode_attention(q, k, v, n) for n in (3000, 100, 3000, 1)]
    torch.cuda.synchronize()
    for n, out in zip((3000, 100, 3000, 1), outs):
        assert _close(out, DK.decode_attention_plain(q, k, v, n),
                      torch.bfloat16)
    assert torch.equal(outs[0], outs[2])


def test_attention_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, (2, 256, 64), torch.float32, cuda)
    idx = torch.zeros((2, 2, 2), dtype=torch.int32, device=cuda)
    cnt = torch.ones((2, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):        # sq not a multiple of q_block
        BK.block_sparse_attention(q[:, :200].contiguous(), q, q, idx, cnt)
    with pytest.raises(ValueError):        # non-contiguous k
        BK.block_sparse_attention(q, q.transpose(0, 1).contiguous()
                                  .transpose(0, 1), q, idx, cnt)
    with pytest.raises(ValueError):        # a CPU tensor
        BK.block_sparse_attention(q.cpu(), q.cpu(), q.cpu(), idx.cpu(),
                                  cnt.cpu())
    dq = _randn(gen, (1, 8, 64), torch.float32, cuda)
    dk = _randn(gen, (1, 100, 2, 64), torch.float32, cuda)
    with pytest.raises(ValueError):        # kv_len > skv
        DK.decode_attention(dq, dk, dk, 101)
    with pytest.raises(ValueError):        # non-contiguous k
        DK.decode_attention(dq, dk[:, ::2], dk[:, ::2], 10)
    with pytest.raises(ValueError):        # a CPU tensor
        DK.decode_attention(dq.cpu(), dk.cpu(), dk.cpu(), 10)
    flat = _randn(gen, (dk.numel() + 1,), torch.float32, cuda)
    with pytest.raises(ValueError):        # k not 16-byte aligned
        DK.decode_attention(dq, flat[1:].view(dk.shape), dk, 10)
    with pytest.raises(ValueError):        # 3 query heads per kv head
        DK.decode_attention(_randn(gen, (1, 6, 64), torch.float32, cuda),
                            dk, dk, 10)
