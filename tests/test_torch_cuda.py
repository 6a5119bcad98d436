"""The port on the card: each CUDA kernel against its plain version, and
the serving path through the kernels. Imports no JAX, so it runs where
only PyTorch is installed; without a card every case skips.

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.compression import huffman  # noqa: E402
from repro_torch.compression.quantize import quantize  # noqa: E402
from repro_torch.configs import SparKVConfig, get_smoke  # noqa: E402
from repro_torch.kernels.block_sparse_attn import kernel as BK  # noqa: E402
from repro_torch.kernels.block_sparse_attn import ops as BO  # noqa: E402
from repro_torch.kernels.block_sparse_attn.ops import \
    block_lists  # noqa: E402
from repro_torch.kernels.decode_attn import kernel as DK  # noqa: E402
from repro_torch.kernels.decode_attn import ops as DO  # noqa: E402
from repro_torch.kernels.huffman_decode import kernel as HK  # noqa: E402
from repro_torch.kernels.huffman_decode import ops as HO  # noqa: E402
from repro_torch.kernels.kv_dequant import kernel as K  # noqa: E402
from repro_torch.kernels.kv_dequant import ops as KO  # noqa: E402
from repro_torch.kernels.moe_decode import kernel as MK  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import SparKVServer  # noqa: E402
from torch_huffman_cases import HUFFMAN_CASES, huffman_symbols  # noqa: E402

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n,width,group", [
    (2048, 512, 64), (37, 128, 64), (129, 128, 32), (5, 192, 64),
    # groups that are not a multiple of 16; at width 20 (group 5) and 36
    # (group 12) the rows' vectors straddle two rows
    (16, 128, 8), (9, 96, 24), (6, 120, 40), (3, 200, 100), (7, 20, 5),
    (5, 36, 12)])
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
    with pytest.raises(ValueError):        # group 24 does not divide 128
        K.kv_dequant(codes, params[:, :5].contiguous(),
                     zeros[:, :5].contiguous(), group=24)
    with pytest.raises(ValueError):        # nor in the mixed form
        K.kv_dequant_mixed(codes, params[:, :5].contiguous(),
                           zeros[:, :5].contiguous(), bits, group=24)
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
    # groups that are not a multiple of 16: every entry padded to a
    # 16-byte boundary of the flat codes; ragged counts
    (8, False, [("k", 0, 1000, 5), ("v", 0, 999, 5), ("k", 2, 33, 5),
                ("v", 3, 4096, 5), ("k", 4, 17, 5), ("v", 5, 1, 5)]),
    (24, False, [("k", 1, 100, 4), ("v", 1, 4096, 4), ("v", 4, 31, 4),
                 ("k", 5, 4095, 4)]),
    (40, False, [("k", 0, 41, 5), ("v", 2, 4000, 5), ("k", 3, 7, 5)]),
    (8, True, [("k", 0, 1000, 3), ("v", 0, 1001, 8), ("k", 1, 4096, 5),
               ("v", 2, 65, 4), ("k", 3, 7, 6)]),
    (24, True, [("k", 0, 48, 4), ("k", 2, 4001, 6), ("v", 2, 4000, 5),
                ("v", 5, 129, 3)]),
    (40, True, [("v", 1, 4096, 5), ("k", 3, 333, 5), ("k", 4, 39, 8)]),
]
SENTINEL = -7.25


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
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


@pytest.mark.parametrize("sched,group", [
    ("uniform", 32), ("attention", 32), ("uniform", 8), ("attention", 24)])
def test_serving_on_card_goes_through_kernels(cuda, sched, group):
    """A small server on the card dequantizes every streamed chunk in one
    launch (uniform or mixed form), and assembles exactly the cache a CPU
    server assembles from the same stored context with the plain
    versions; also at quantization groups that are not a multiple of
    16."""
    cfg = get_smoke("sparkv-qwen3-4b", layers=3, d_model=64, heads=4,
                    d_ff=128, vocab=256)
    spcfg = SparKVConfig(chunk_tokens=32, q_block=16, kv_block=16,
                         quant_group=group, alloc_schedule=sched)
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


def test_moe_served_on_card_through_one_dequant_launch(cuda):
    """granite-moe-3b-a800m's smoke config served on the card: a cachegen
    request dequantizes every streamed chunk (head_dim 16) in one
    kv_dequant launch, bit-equal to a CPU server's assembly of the same
    stored context; local_prefill decodes what the exact cache decodes."""
    cfg = get_smoke("granite-moe-3b-a800m", layers=3, d_model=64, heads=4,
                    d_ff=128, vocab=256)
    spcfg = SparKVConfig(chunk_tokens=32, q_block=16, kv_block=16,
                         quant_group=32)
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    srv = SparKVServer(model, params, spcfg, chunk_tokens=32, device=cuda)
    cid = srv.register_context(
        np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, 96)))
    K.reset_launches()
    _, res = srv.load_context(cid, policy="cachegen")
    assert K.LAUNCHES == {"kv_dequant": 1, "kv_dequant_mixed": 0}
    st = srv.contexts[cid]
    streamed = sorted(res.engine.streamed_set)
    gk, gv = srv.assemble(st, streamed)
    cpu = SparKVServer(model, params, spcfg, chunk_tokens=32, device="cpu")
    cst = type(st)(tokens=st.tokens, exact_k=st.exact_k.cpu(),
                   exact_v=st.exact_v.cpu(), encoded=st.encoded, wl=st.wl,
                   n_chunks=st.n_chunks)
    ck, cv = cpu.assemble(cst, streamed)
    assert _same_bits(gk.cpu(), ck) and _same_bits(gv.cpu(), cv)
    res = srv.generate(cid, np.arange(4), max_new=8, policy="local_prefill")
    assert res.top1_agreement == 1.0


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_block_on_card_matches_cpu(cuda, capacity_factor):
    """The MoE block on the card against the same function on the CPU, in
    fp32 with TF32 off: the same routing and drops, outputs equal up to
    fp32 summation order in the expert matmuls (atol 1e-5 on outputs of
    magnitude ~0.1), the router loss within 1e-6."""
    import dataclasses

    from repro_torch.models import layers as L
    cfg = get_smoke("granite-moe-3b-a800m", d_model=64, d_ff=128)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    gen = torch.Generator().manual_seed(0)
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    p = {"router": torch.randn((d, e), generator=gen) * 0.1,
         "w_up": torch.randn((e, d, f), generator=gen) * 0.1,
         "w_gate": torch.randn((e, d, f), generator=gen) * 0.1,
         "w_down": torch.randn((e, f, d), generator=gen) * 0.1}
    x = torch.randn((2, 32, d), generator=gen)
    y, aux = L.moe_block_local(cfg, p, x)
    gp = {k: v.to(cuda) for k, v in p.items()}
    gy, gaux = L.moe_block_local(cfg, gp, x.to(cuda))
    assert torch.allclose(gy.cpu(), y, atol=1e-5, rtol=0)
    assert abs(float(gaux) - float(aux)) < 1e-6
    idx = L.moe_gates(cfg, p, x.reshape(64, d))[2]
    gidx = L.moe_gates(cfg, gp, x.to(cuda).reshape(64, d))[2]
    assert torch.equal(gidx.cpu(), idx)
    assert L.moe_dropped(cfg, gidx) == L.moe_dropped(cfg, idx)
    if capacity_factor < 1:           # 8 slots under a mean load of 16
        assert L.moe_dropped(cfg, idx) > 0


# attention tolerances of tests/test_kernels.py, compared in fp32, scaled
# down where the reference's largest magnitude is under 1 (long random
# caches average their values towards 0); fp16 that of
# tests/test_torch_kernel_shapes.py (two fp16 steps at magnitudes under 4:
# each version rounds p and the output on its own)
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 4e-3}


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
    (1, 4, 384, 128, False, 0.98),
    # the head shapes of granite-moe-3b-a800m, starcoder2-3b, zamba2-2.7b
    # and gemma-2b: (hq, hkv, d) (24, 8, 64), (24, 2, 128), (32, 32, 80),
    # (8, 1, 256)
    (8, 3, 256, 64, True, 0.95), (2, 12, 256, 128, True, 0.95),
    (32, 1, 512, 80, True, 0.9), (1, 8, 512, 256, True, 0.9),
    (4, 1, 384, 80, False, 0.9), (1, 8, 256, 256, False, 0.98)])
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
    (1, 32, 8, 96, 128, 61, 256), (2, 8, 8, 300, 32, 1, 64),
    # granite-moe-3b-a800m, starcoder2-3b, zamba2-2.7b, gemma-2b
    (2, 24, 8, 512, 64, 333, 256), (1, 24, 2, 2048, 128, 1999, 256),
    (1, 32, 32, 2048, 80, 2048, 256), (2, 8, 1, 640, 256, 577, 128)])
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
    (1, 1, 768, 128, 128, 64), (1, 8, 256, 128, 128, 128),
    # d 80 (rows padded to 11 chunks) and d 256 (Q in shared memory, two
    # stages), at 64 and 128 query rows a CTA
    (2, 1, 512, 80, 64, 64), (1, 4, 512, 80, 256, 128),
    (1, 2, 512, 256, 64, 256), (1, 8, 512, 256, 128, 64)])
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
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_block,kv_block,d,s", [
    (16, 16, 64, 320), (32, 32, 128, 320), (96, 96, 64, 384),
    (128, 32, 128, 384), (48, 80, 80, 480), (32, 96, 256, 384),
    (16, 64, 128, 320), (64, 16, 64, 320)])
def test_block_sparse_at_block_sizes_of_16(cuda, q_block, kv_block, d, s,
                                           causal, dtype):
    """Blocks that are multiples of 16 but not of 64: CTAs of 16 or 32
    query rows, sub-tiles gathered from several kv blocks (16, 32) or
    spanning one and a half (96), on lists with holes and on the lists
    of the serving mass."""
    g, bh_kv = 2, 2
    gen = torch.Generator(device=cuda).manual_seed(q_block + kv_block + d)
    q = _randn(gen, (bh_kv * g, s, d), dtype, cuda)
    k = _randn(gen, (bh_kv, s, d), dtype, cuda)
    v = _randn(gen, (bh_kv, s, d), dtype, cuda)
    holes = _lists_with_holes(gen, bh_kv * g, s // q_block, s // kv_block,
                              cuda)
    lists = block_lists(q, k, g, mass=0.9, q_block=q_block,
                        kv_block=kv_block, causal=causal)
    for idx, cnt, seen, seen_cnt in (holes, (*lists, *lists)):
        before = BK.LAUNCHES["block_sparse_attention"]
        out = BK.block_sparse_attention(q, k, v, idx, cnt, causal=causal,
                                        q_block=q_block, kv_block=kv_block,
                                        kv_group=g)
        assert BK.LAUNCHES["block_sparse_attention"] == before + 1
        plain = BK.block_sparse_attention_plain(
            q, k, v, seen, seen_cnt, causal=causal, q_block=q_block,
            kv_block=kv_block, kv_group=g)
        torch.cuda.synchronize()
        assert out.dtype == dtype
        assert _close(out, plain, dtype)
    assert not out.isnan().any()


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
    with pytest.raises(ValueError):        # hq not a multiple of hkv
        DK.decode_attention(_randn(gen, (1, 5, 64), torch.float32, cuda),
                            dk, dk, 10)
    with pytest.raises(ValueError):        # 3 q rows over 2 kv rows
        BK.block_sparse_attention(_randn(gen, (3, 256, 64), torch.float32,
                                         cuda), q, q, idx, cnt, kv_group=1)
    big = torch.zeros((2, 256, 4097), device=cuda)
    with pytest.raises(ValueError, match="limit"):   # d past 4096
        BK.block_sparse_attention(big, big, big, idx, cnt)
    dbig = torch.zeros((1, 2, 2049), device=cuda)
    with pytest.raises(ValueError, match="limit"):   # d past 2048
        DK.decode_attention(dbig, dbig[:, None], dbig[:, None], 1)
    # once refused, now taken by the generic kernels: 17 query heads per
    # kv head, head size 48
    q34 = _randn(gen, (1, 34, 64), torch.float32, cuda)
    assert _close(DK.decode_attention(q34, dk, dk, 10),
                  DK.decode_attention_plain(q34, dk, dk, 10), torch.float32)
    q48 = _randn(gen, (1, 8, 48), torch.float32, cuda)
    k48 = _randn(gen, (1, 100, 2, 48), torch.float32, cuda)
    assert _close(DK.decode_attention(q48, k48, k48, 10),
                  DK.decode_attention_plain(q48, k48, k48, 10),
                  torch.float32)
    b48 = _randn(gen, (2, 256, 48), torch.float32, cuda)
    assert _close(BK.block_sparse_attention(b48, b48, b48, idx, cnt),
                  BK.block_sparse_attention_plain(b48, b48, b48, idx, cnt),
                  torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", range(1, 17))
def test_decode_every_group(cuda, g, dtype):
    """g 1 to 16 query heads a kv head at d 80: the fp32 kernel's groups
    between its templates (5-7, 9-11, 13-15) run on the next one up with
    the extra rows masked; one launch a call."""
    gen = torch.Generator(device=cuda).manual_seed(g)
    q = _randn(gen, (2, 2 * g, 80), dtype, cuda)
    k = _randn(gen, (2, 700, 2, 80), dtype, cuda)
    v = _randn(gen, (2, 700, 2, 80), dtype, cuda)
    before = DK.LAUNCHES["decode_attention"]
    out = DK.decode_attention(q, k, v, 650)
    assert DK.LAUNCHES["decode_attention"] == before + 1
    plain = DK.decode_attention_plain(q, k, v, 650)
    torch.cuda.synchronize()
    assert _close(out, plain, dtype)


# the shapes of tests/test_torch_kernel_shapes.py: (head size, (q_block,
# kv_block), group) over 120 tokens, and decode's (head size, group)
GENERIC_BSA = [(48, (24, 24), 3), (48, (8, 8), 1), (96, (8, 8), 3),
               (96, (40, 20), 1), (160, (40, 20), 1), (160, (24, 24), 3),
               (512, (8, 8), 1), (512, (40, 20), 3)]
GENERIC_DEC = [(d, g) for d in (48, 96, 512) for g in (20, 32)]
DTYPES3 = [torch.float32, torch.bfloat16, torch.float16]
# the generic kernels' tiers and staging: d 33 (rows that are not whole
# 16-byte pieces: copied element by element), 264 (the first past the 256
# tier: two CTAs of O's columns), 4096 (sixteen), and kv blocks of 40
# rows (five 8-row segments) under q-blocks of 24
TIER_BSA = [(33, (24, 24), 2), (264, (24, 40), 1), (4096, (24, 40), 1),
            (96, (24, 40), 3)]


def _launched(counts, fn):
    before = dict(counts)
    out = fn()
    return out, {k: counts[k] - before[k] for k in counts if
                 counts[k] != before[k]}


@pytest.mark.parametrize("dtype", DTYPES3)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,blocks,g", GENERIC_BSA + TIER_BSA)
def test_block_sparse_generic_matches_plain(cuda, d, blocks, g, causal,
                                            dtype):
    """The generic kernel, one launch a call and no fast launch, against
    the plain version on lists with holes and on the lists of mass 0.9."""
    (qb, kb), s = blocks, 120
    gen = torch.Generator(device=cuda).manual_seed(d + qb + g)
    q = _randn(gen, (2 * g, s, d), dtype, cuda)
    k = _randn(gen, (2, s, d), dtype, cuda)
    v = _randn(gen, (2, s, d), dtype, cuda)
    holes = _lists_with_holes(gen, 2 * g, s // qb, s // kb, cuda)
    lists = block_lists(q, k, g, mass=0.9, q_block=qb, kv_block=kb,
                        causal=causal)
    for idx, cnt, seen, seen_cnt in (holes, (*lists, *lists)):
        kw = dict(causal=causal, q_block=qb, kv_block=kb, kv_group=g)
        out, n = _launched(BK.LAUNCHES, lambda: BK.block_sparse_attention(
            q, k, v, idx, cnt, **kw))
        assert n == {"block_sparse_attention_generic": 1}
        plain = BK.block_sparse_attention_plain(q, k, v, seen, seen_cnt,
                                                **kw)
        torch.cuda.synchronize()
        assert out.dtype == dtype and _close(out, plain, dtype)


@pytest.mark.parametrize("dtype", DTYPES3)
@pytest.mark.parametrize("d,g", GENERIC_DEC)
def test_decode_generic_matches_plain(cuda, d, g, dtype):
    """The generic kernel over one split (kv_len 301) and many (5000),
    one launch a call, and kv_len 0 (zeros)."""
    gen = torch.Generator(device=cuda).manual_seed(d + g)
    q = _randn(gen, (2, 2 * g, d), dtype, cuda)
    k = _randn(gen, (2, 5120, 2, d), dtype, cuda)
    v = _randn(gen, (2, 5120, 2, d), dtype, cuda)
    for kv_len in (301, 5000, 0):
        out, n = _launched(DK.LAUNCHES, lambda: DK.decode_attention(
            q, k, v, kv_len))
        assert n == {"decode_attention_generic": 1}
        plain = DK.decode_attention_plain(q, k, v, kv_len)
        torch.cuda.synchronize()
        assert out.dtype == dtype and _close(out, plain, dtype)
        if kv_len == 0:
            assert not out.any()


@pytest.mark.parametrize("dtype", DTYPES3)
@pytest.mark.parametrize("d,g,kv_len", [
    (64, 17, 1999), (96, 48, 1999), (64, 71, 1999), (2048, 2, 1999),
    (64, 71, 1), (64, 71, 0), (2048, 2, 1), (2048, 2, 0)])
def test_decode_generic_groups_and_lengths(cuda, d, g, kv_len, dtype):
    """Groups past the fast set (17; 48, StarCoder-15B's 48 over 1; 71,
    Falcon-7B's 71 over 1: two CTAs of heads a split), head size 2048
    (eight CTAs of O's columns), kv_len 1 and 0: one generic launch a
    call against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(d + g + kv_len)
    q = _randn(gen, (2, g, d), dtype, cuda)
    k = _randn(gen, (2, 2000, 1, d), dtype, cuda)
    v = _randn(gen, (2, 2000, 1, d), dtype, cuda)
    out, n = _launched(DK.LAUNCHES, lambda: DK.decode_attention(
        q, k, v, kv_len))
    assert n == {"decode_attention_generic": 1}
    plain = DK.decode_attention_plain(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert out.dtype == dtype and _close(out, plain, dtype)
    if kv_len == 0:
        assert not out.any()


@pytest.mark.parametrize("dtype", DTYPES3)
@pytest.mark.parametrize("kv_len", [31_999, 12_345])
def test_decode_generic_at_path_o_shape(cuda, kv_len, dtype):
    """chip_smoke path O's generic decode shape (40/2 heads of 96) at
    lengths that the generic split does not divide: many splits, a short
    last one, combined through the workspace; one launch a call."""
    gen = torch.Generator(device=cuda).manual_seed(kv_len)
    q = _randn(gen, (1, 40, 96), dtype, cuda)
    k = _randn(gen, (1, 32000, 2, 96), dtype, cuda)
    v = _randn(gen, (1, 32000, 2, 96), dtype, cuda)
    chunk, n_split = DK.split_plan_generic(
        2 * DK.head_chunks(20, dtype), kv_len,
        torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert n_split > 1 and kv_len % chunk
    out, n = _launched(DK.LAUNCHES, lambda: DK.decode_attention(
        q, k, v, kv_len))
    assert n == {"decode_attention_generic": 1}
    plain = DK.decode_attention_plain(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert out.dtype == dtype and _close(out, plain, dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_fp16_on_the_tensor_cores(cuda, causal):
    """fp16 at Qwen3-4B's heads (32 over 8 of 128) takes the fast
    kernels: block-sparse at 128- and 32-row blocks, decode at 2048."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    dt = torch.float16
    q = _randn(gen, (32, 512, 128), dt, cuda)
    k = _randn(gen, (8, 512, 128), dt, cuda)
    v = _randn(gen, (8, 512, 128), dt, cuda)
    for blk in (128, 32):
        idx, cnt = block_lists(q, k, 4, mass=0.95, q_block=blk,
                               kv_block=blk, causal=causal)
        kw = dict(causal=causal, q_block=blk, kv_block=blk, kv_group=4)
        out, n = _launched(BK.LAUNCHES, lambda: BK.block_sparse_attention(
            q, k, v, idx, cnt, **kw))
        assert n == {"block_sparse_attention": 1}
        assert _close(out, BK.block_sparse_attention_plain(q, k, v, idx,
                                                           cnt, **kw), dt)
    dq = _randn(gen, (1, 32, 128), dt, cuda)
    dk = _randn(gen, (1, 2048, 8, 128), dt, cuda)
    out, n = _launched(DK.LAUNCHES, lambda: DK.decode_attention(
        dq, dk, dk, 2048))
    assert n == {"decode_attention": 1}
    assert _close(out, DK.decode_attention_plain(dq, dk, dk, 2048), dt)


def test_ops_copy_other_layouts_and_count_it(cuda):
    """The ops layer takes q, k, v in any layout: a transposed or
    misaligned input is copied (counted in COPIES) and the result equals
    the kernel's on dense inputs; dense inputs are not copied."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = _randn(gen, (4, 256, 64), torch.bfloat16, cuda)
    k = _randn(gen, (2, 256, 64), torch.bfloat16, cuda)
    idx, cnt = block_lists(q, k, 2, mass=0.9, q_block=64, kv_block=64,
                           causal=True)
    kw = dict(q_block=64, kv_block=64, kv_group=2)
    dense = BO.block_sparse_attention(q, k, k, idx, cnt, **kw)
    c0 = BO.COPIES["block_sparse_attention"]
    qt = q.transpose(0, 1).contiguous().transpose(0, 1)
    flat = torch.empty(k.numel() + 1, dtype=k.dtype, device=cuda)
    kmis = flat[1:].view(k.shape)
    kmis.copy_(k)
    out = BO.block_sparse_attention(qt, kmis, k, idx, cnt, **kw)
    assert BO.COPIES["block_sparse_attention"] == c0 + 2
    assert torch.equal(out, dense)
    dq = _randn(gen, (1, 8, 64), torch.float32, cuda)
    dk = _randn(gen, (1, 300, 2, 64), torch.float32, cuda)
    c0 = DO.COPIES["decode_attention"]
    ref = DO.decode_attention(dq, dk, dk, 300)
    assert DO.COPIES["decode_attention"] == c0
    wide = torch.zeros((1, 300, 2, 128), device=cuda)
    wide[..., :64] = dk
    out = DO.decode_attention(dq, wide[..., :64], wide[..., :64], 300)
    assert DO.COPIES["decode_attention"] == c0 + 2
    assert torch.equal(out, ref)


# Two key segments (the serving path's context and decode tail): the cells'
# heads (Qwen3-4B 32/8x128, Granite-3.0 24/8x64, Granite-4.0-H 32/8x128 at
# its attention_multiplier), their context lengths (HotpotQA 11,264,
# GovReport 13,312) and lengths that are not a multiple of 64, tails of 1,
# 57 and 128 slots
SEG_HEADS = [(32, 8, 128, None), (24, 8, 64, None), (32, 8, 128, 0.0078125)]


@pytest.mark.parametrize("dtype", DTYPES3)
@pytest.mark.parametrize("kv_len2", [1, 57, 128])
@pytest.mark.parametrize("ctx", [11_264, 13_312, 1000, 61])
@pytest.mark.parametrize("hq,hkv,d,scale", SEG_HEADS)
def test_decode_two_segments_match_plain(cuda, hq, hkv, d, scale, ctx,
                                         kv_len2, dtype):
    """The fast kernels (bf16 and fp16 on the tensor cores, fp32 on the
    CUDA cores) over a context and a 128-slot tail as two segments, one
    launch a call, against the plain version; tail slots past kv_len2
    hold values that must not count."""
    gen = torch.Generator(device=cuda).manual_seed(ctx + kv_len2 + d)
    q = _randn(gen, (1, hq, d), dtype, cuda)
    ck, cv = (_randn(gen, (1, ctx, hkv, d), dtype, cuda) for _ in range(2))
    tk, tv = (_randn(gen, (1, 128, hkv, d), dtype, cuda) for _ in range(2))
    out, n = _launched(DK.LAUNCHES, lambda: DK.decode_attention(
        q, ck, cv, ctx, k2=tk, v2=tv, kv_len2=kv_len2, scale=scale))
    assert n == {"decode_attention": 1}
    plain = DK.decode_attention_plain(q, ck, cv, ctx, k2=tk, v2=tv,
                                      kv_len2=kv_len2, scale=scale)
    torch.cuda.synchronize()
    assert out.dtype == dtype and _close(out, plain, dtype)


@pytest.mark.parametrize("dtype", DTYPES3)
@pytest.mark.parametrize("d,g", GENERIC_DEC)
def test_decode_generic_two_segments_match_plain(cuda, d, g, dtype):
    """The generic kernel over two segments, one split (300 + 1 keys) and
    many (5000 + 128, 999 + 57), one launch a call (its combine is part of
    the call), against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(d * g)
    q = _randn(gen, (2, 2 * g, d), dtype, cuda)
    k, v = (_randn(gen, (2, 5000, 2, d), dtype, cuda) for _ in range(2))
    k2, v2 = (_randn(gen, (2, 128, 2, d), dtype, cuda) for _ in range(2))
    for kv_len, kv_len2 in ((300, 1), (5000, 128), (999, 57), (0, 5)):
        out, n = _launched(DK.LAUNCHES, lambda: DK.decode_attention(
            q, k, v, kv_len, k2=k2, v2=v2, kv_len2=kv_len2))
        assert n == {"decode_attention_generic": 1}
        plain = DK.decode_attention_plain(q, k, v, kv_len, k2=k2, v2=v2,
                                          kv_len2=kv_len2)
        torch.cuda.synchronize()
        assert out.dtype == dtype and _close(out, plain, dtype)


@pytest.mark.parametrize("dtype", DTYPES3)
@pytest.mark.parametrize("hq,hkv,d,cut", [
    (32, 8, 128, 1000), (24, 8, 64, 11_263), (32, 8, 128, 64),
    (40, 2, 96, 777), (40, 2, 96, 4096)])
def test_decode_one_cache_cut_in_two_is_bit_equal(cuda, hq, hkv, d, cut,
                                                  dtype):
    """A cache cut into two segments at any key (a multiple of 64 or not)
    gives the split the same keys in the same order: bit-equal to the
    one-segment call, fast and generic kernels; a second segment of no
    keys is bit-equal too."""
    gen = torch.Generator(device=cuda).manual_seed(cut + d)
    skv = 12_000
    q = _randn(gen, (1, hq, d), dtype, cuda)
    k, v = (_randn(gen, (1, skv, hkv, d), dtype, cuda) for _ in range(2))
    one = DK.decode_attention(q, k, v, skv)
    two = DK.decode_attention(q, k[:, :cut], v[:, :cut], cut, k2=k[:, cut:],
                              v2=v[:, cut:], kv_len2=skv - cut)
    none = DK.decode_attention(q, k, v, skv, k2=k[:, :8], v2=v[:, :8],
                               kv_len2=0)
    torch.cuda.synchronize()
    assert torch.equal(one, two) and torch.equal(one, none)


def _served(cfg, cuda, *, eager=False, monkeypatch=None):
    """A context registered on a card server and one local_prefill request
    (4 prompt tokens, 8 new), with the decode attention's eager path
    forced where `eager`: its result, and its decode attentions' kernel
    launches and eager calls."""
    from repro_torch.models import transformer as T
    spcfg = SparKVConfig(chunk_tokens=32, q_block=16, kv_block=16,
                         quant_group=32)
    model = build_model(cfg)
    srv = SparKVServer(model, model.init(0, device=cuda), spcfg,
                       chunk_tokens=32, device=cuda)
    cid = srv.register_context(
        np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, 96)))
    if eager:
        monkeypatch.setattr(T, "_kernel_path", lambda *a: False)
    c0 = DO.COPIES["decode_attention"]
    calls = lambda: (sum(DK.LAUNCHES.values()),
                     T.EAGER_CALLS["decode_attention"])
    n0 = calls()
    res = srv.generate(cid, np.arange(4), max_new=8, policy="local_prefill",
                       compare_exact=False)
    assert DO.COPIES["decode_attention"] == c0
    return (res, *(a - b for a, b in zip(calls(), n0)))


@pytest.mark.parametrize("arch,kw", [
    ("sparkv-qwen3-4b", dict(d_model=512, heads=8, kv_heads=2)),
    ("granite-moe-3b-a800m", dict(d_model=384, heads=6, kv_heads=2))])
def test_served_decode_attends_through_the_kernel(cuda, arch, kw,
                                                  monkeypatch):
    """A card server's decode attends through the flash-decode kernel: one
    fast-kernel launch a layer a step (kernel launches = steps x layers,
    no eager call), no copy of the cache's context or tail on the way
    (COPIES), and the tokens the eager path decodes."""
    cfg = get_smoke(arch, layers=2, d_ff=128, vocab=256, **kw)
    g0 = DK.LAUNCHES["decode_attention_generic"]
    res, n_kernel, n_eager = _served(cfg, cuda)
    assert DK.LAUNCHES["decode_attention_generic"] == g0
    assert n_kernel == (4 + 8) * cfg.num_layers
    assert n_eager == 0
    eager, n_kernel, n_eager = _served(cfg, cuda, eager=True,
                                       monkeypatch=monkeypatch)
    assert n_kernel == 0
    assert n_eager == (4 + 8) * cfg.num_layers
    assert np.array_equal(res.tokens, eager.tokens)


# ---------------------------------------------------------------------------
# Routed experts of a decode-sized MoE step
# ---------------------------------------------------------------------------

# (d, f, e, k, capacity_factor) of the benchmark's Granite-3.0 and
# Granite-4.0-H cells, and the route's largest t at each
MOE_CELLS = {"granite-3.0": ((1536, 512, 40, 8, 1.25), 4),
             "granite-4.0-h": ((4096, 768, 72, 10, 7.2), 7)}


def _moe_cfg(d, f, e, k, cf, activation="swiglu"):
    from repro_torch.configs.base import MoEConfig
    cfg = get_smoke("granite-moe-3b-a800m", d_model=d, d_ff=f)
    return dataclasses.replace(cfg, activation=activation, moe=MoEConfig(
        num_experts=e, experts_per_token=k, capacity_factor=cf))


def _moe_params(d, f, e, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = lambda *s: (torch.randn(s, generator=gen, device=device)
                       * 0.02).to(dtype)
    return {"router": draw(d, e), "w_up": draw(e, d, f),
            "w_gate": draw(e, d, f), "w_down": draw(e, f, d)}


def _moe_close(out, ref, dtype):
    """Within four steps of the dtype at the reference's largest magnitude
    (fp32: 1e-5 of it). The kernel sums each dot product in another order
    than cuBLAS, so a rounding of a gate, up, product or expert output may
    move by a step, and a router logit's rounding may move a gate by a
    step of its own, which reaches y through the renormalisation."""
    tol = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6,
           torch.float16: 2.0 ** -9}[dtype]
    top = float(ref.float().abs().max())
    return float((out.float() - ref.float()).abs().max()) <= tol * top


@pytest.mark.parametrize("t", [1, 2, "limit"])
@pytest.mark.parametrize("cell", list(MOE_CELLS))
def test_moe_decode_matches_plain_and_eager(cuda, cell, t):
    """bf16 on the card at the cells' widths, every expert: the kernel (one
    launch a call) against the plain version and moe_block_local run
    eagerly; the aux loss within 1e-3 (a router logit rounded one step
    apart moves a probability by ~1%, the loss by ~1e-4)."""
    from repro_torch.models import layers as L
    (d, f, e, k, cf), limit = MOE_CELLS[cell]
    t = limit if t == "limit" else t
    cfg = _moe_cfg(d, f, e, k, cf)
    p = _moe_params(d, f, e, torch.bfloat16, cuda, seed=t)
    x = _randn(torch.Generator(device=cuda).manual_seed(50 + t), (1, t, d),
               torch.bfloat16, cuda)
    args = (p["router"], p["w_gate"], p["w_up"], p["w_down"], k)
    (y, aux), n = _launched(MK.LAUNCHES, lambda: MK.moe_decode(x, *args))
    assert n == {"moe_decode": 1}
    py, paux = MK.moe_decode_plain(x, *args)
    ey, eaux = L.moe_block_local(cfg, p, x)
    torch.cuda.synchronize()
    assert y.shape == x.shape and y.dtype == x.dtype and aux.dim() == 0
    assert _moe_close(y, py, torch.bfloat16)
    assert _moe_close(y, ey, torch.bfloat16)
    assert abs(float(aux) - float(eaux)) <= 1e-3
    assert abs(float(paux) - float(eaux)) <= 1e-6
    # the same bits every run: no atomics
    assert torch.equal(MK.moe_decode(x, *args)[0], y)


@pytest.mark.parametrize("dtype,activation", [
    (torch.float32, "swiglu"), (torch.float16, "swiglu"),
    (torch.bfloat16, "geglu")])
def test_moe_decode_other_dtypes_and_activation(cuda, dtype, activation):
    """fp32 and fp16 at the smoke width and 3 tokens, and GeGLU in bf16,
    against the plain version (fp32 with TF32 off)."""
    d, f, e, k = 64, 128, 8, 2
    p = _moe_params(d, f, e, dtype, cuda, seed=9)
    x = _randn(torch.Generator(device=cuda).manual_seed(9), (3, d), dtype,
               cuda)
    args = (p["router"], p["w_gate"], p["w_up"], p["w_down"], k, activation)
    y, aux = MK.moe_decode(x, *args)
    py, paux = MK.moe_decode_plain(x, *args)
    torch.cuda.synchronize()
    assert _moe_close(y, py, dtype)
    assert abs(float(aux) - float(paux)) <= 1e-3


def test_moe_decode_router_ties_go_to_the_lower_expert(cuda):
    """Equal router columns on the card: the kernel picks the lowest ids
    among them, as the plain version's stable sort does (equal y)."""
    d, f, e, k = 64, 128, 16, 4
    p = _moe_params(d, f, e, torch.bfloat16, cuda, seed=1)
    p["router"][:, [3, 6, 9, 12, 15]] = p["router"][:, 12:13] + 0.5
    x = torch.ones((2, d), dtype=torch.bfloat16, device=cuda)
    args = (p["router"], p["w_gate"], p["w_up"], p["w_down"], k)
    y, _ = MK.moe_decode(x, *args)
    py, _ = MK.moe_decode_plain(x, *args)
    torch.cuda.synchronize()
    assert MK.route_plain(x, p["router"], k)[1].tolist() == [[3, 6, 9, 12]] * 2
    assert _moe_close(y, py, torch.bfloat16)


def _moe_served(model, cuda):
    """One local_prefill request (4 prompt tokens, 8 new) on a card
    server: its result and the moe_decode launches during it."""
    spcfg = SparKVConfig(chunk_tokens=32, q_block=16, kv_block=16,
                         quant_group=32)
    srv = SparKVServer(model, model.init(0, device=cuda), spcfg,
                       chunk_tokens=32, device=cuda)
    cid = srv.register_context(
        np.random.default_rng(0).integers(0, 256, size=(1, 96)))
    n0 = MK.LAUNCHES["moe_decode"]
    res = srv.generate(cid, np.arange(4), max_new=8, policy="local_prefill",
                       compare_exact=False)
    return res, MK.LAUNCHES["moe_decode"] - n0


def _tiny_hybrid():
    from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig
    from repro_torch.models.granite_hybrid import GraniteHybridConfig
    base = ModelConfig(
        name="tiny-granite-4.0-h", family="hybrid_moe", num_layers=10,
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32,
        vocab_size=256, activation="swiglu", norm="rmsnorm",
        tie_embeddings=True,
        moe=MoEConfig(num_experts=8, experts_per_token=2,
                      capacity_factor=4.0),
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, chunk_len=16,
                      conv_width=4))
    return GraniteHybridConfig(
        base=base, layer_types=("mamba",) * 5 + ("attention",)
        + ("mamba",) * 4, shared_d_ff=48, embedding_multiplier=12.0,
        attention_multiplier=0.0625, residual_multiplier=0.22,
        logits_scaling=16.0)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "granite-4.0-h",
                                  "sparkv-qwen3-4b"])
def test_served_moe_decode_takes_the_kernel(cuda, arch, monkeypatch):
    """A card server's decode step routes every MoE layer through the
    kernel: launches = MoE layers x decode steps (4 + 8); the prefills
    (96 tokens) keep the eager dispatch; a dense model launches none. The
    Granite-3.0 request decodes the tokens the eager dispatch decodes."""
    from repro_torch.models import layers as L
    if arch == "granite-4.0-h":
        cfg = _tiny_hybrid()
    else:
        cfg = get_smoke(arch, layers=2, d_ff=128, vocab=256,
                        d_model=384, heads=6, kv_heads=2)
    model = build_model(cfg)
    res, n = _moe_served(model, cuda)
    moe_layers = cfg.num_layers if cfg.moe is not None else 0
    assert n == (4 + 8) * moe_layers
    if arch == "granite-moe-3b-a800m":
        monkeypatch.setattr(L, "decode_route", lambda *a: False)
        eager, n = _moe_served(model, cuda)
        assert n == 0
        assert np.array_equal(res.tokens, eager.tokens)


def test_grids_past_65535(cuda):
    """bh past 65535 in block-sparse (fp32 on the flattened grid of the
    fast kernel, bf16 on gridDim.x) and b past 65535 in decode (the
    generic kernel's folded grid)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    for dt in (torch.float32, torch.bfloat16):
        q = _randn(gen, (70000, 16, 64), dt, cuda)
        idx = torch.zeros((70000, 1, 1), dtype=torch.int32, device=cuda)
        cnt = torch.ones((70000, 1), dtype=torch.int32, device=cuda)
        kw = dict(q_block=16, kv_block=16)
        out, n = _launched(BK.LAUNCHES, lambda: BK.block_sparse_attention(
            q, q, q, idx, cnt, **kw))
        assert n == {"block_sparse_attention": 1}
        assert _close(out, BK.block_sparse_attention_plain(q, q, q, idx,
                                                           cnt, **kw), dt)
    dq = _randn(gen, (70000, 2, 32), torch.bfloat16, cuda)
    dk = _randn(gen, (70000, 40, 1, 32), torch.bfloat16, cuda)
    out, n = _launched(DK.LAUNCHES, lambda: DK.decode_attention(
        dq, dk, dk, 33))
    assert n == {"decode_attention_generic": 1}
    assert _close(out, DK.decode_attention_plain(dq, dk, dk, 33),
                  torch.bfloat16)


# ---------------------------------------------------------------------------
# Huffman decode of streamed chunks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("huffman_case", HUFFMAN_CASES)
def test_huffman_kernel_bit_equal_to_the_decoder(cuda, huffman_case):
    """tests/torch_huffman_cases.py's cases (alphabets 2-256, 1-64 streams,
    empty streams, one symbol, codes of 16 bits, an empty tensor), each in
    one launch beside a second tensor: the codes equal ``huffman.decode``'s."""
    symbols, alphabet, streams = huffman_symbols(huffman_case)
    enc = huffman.encode(symbols, alphabet, n_streams=streams)
    other = huffman.encode(np.arange(777, dtype=np.uint16) % 9, 16,
                           n_streams=5)
    before = HK.LAUNCHES["huffman_decode"]
    got = HO.decode([enc, other], cuda)
    assert HK.LAUNCHES["huffman_decode"] == before + 1
    for g, e in zip(got, (enc, other)):
        assert g.dtype == np.uint8
        assert np.array_equal(g, huffman.decode(e))
    assert np.array_equal(got[0], symbols)


def test_huffman_kernel_at_the_cells_chunk(cuda):
    """A streamed chunk of the Qwen3-4B stream cell: K and V of 1,048,576
    five-bit codes each (1024 tokens x 8 heads x 128, groups of 64) from
    quantized random KV, 64 streams, in one launch."""
    rng = np.random.default_rng(11)
    qts = [quantize(rng.normal(size=(1024, 8, 128)).astype(np.float32), 5,
                    64) for _ in range(2)]
    encs = [huffman.encode(q.codes, 32, n_streams=64) for q in qts]
    before = HK.LAUNCHES["huffman_decode"]
    got = HO.decode(encs, cuda)
    assert HK.LAUNCHES["huffman_decode"] == before + 1
    for g, q in zip(got, qts):
        assert g.shape == (1 << 20,) and np.array_equal(g, q.codes)


def _mixed_width_server(cuda):
    cfg = get_smoke("sparkv-qwen3-4b", layers=3, d_model=64, heads=4,
                    d_ff=128, vocab=256)
    spcfg = SparKVConfig(chunk_tokens=32, q_block=16, kv_block=16,
                         quant_group=32, alloc_schedule="attention")
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    srv = SparKVServer(model, params, spcfg, chunk_tokens=32, device=cuda)
    cid = srv.register_context(
        np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, 96)))
    return srv, cid, model, params, spcfg


def test_huffman_decode_on_the_serving_path(cuda):
    """A mixed-width context (alloc_schedule "attention"): a cachegen
    request decodes each streamed chunk, K and V, in one huffman_decode
    launch, and its assembly on the card equals a CPU server's (the
    reference's decoder) bit for bit; local_prefill launches none."""
    srv, cid, model, params, spcfg = _mixed_width_server(cuda)
    st = srv.contexts[cid]
    HK.reset_launches()
    _, res = srv.load_context(cid, policy="cachegen")
    n = res.engine.n_streamed
    assert n == st.n_chunks and HK.LAUNCHES == {"huffman_decode": n}
    streamed = sorted(res.engine.streamed_set)
    assert len({q.bits for c in streamed for q in st.encoded[c][2:]}) > 1
    gk, gv = srv.assemble(st, streamed)
    cpu = SparKVServer(model, params, spcfg, chunk_tokens=32, device="cpu")
    cst = type(st)(tokens=st.tokens, exact_k=st.exact_k.cpu(),
                   exact_v=st.exact_v.cpu(), encoded=st.encoded, wl=st.wl,
                   n_chunks=st.n_chunks)
    ck, cv = cpu.assemble(cst, streamed)
    assert _same_bits(gk.cpu(), ck) and _same_bits(gv.cpu(), cv)
    HK.reset_launches()
    srv.generate(cid, np.arange(4), max_new=2, policy="local_prefill")
    assert HK.LAUNCHES == {"huffman_decode": 0}


def test_flipped_payload_byte_is_bitstream_corruption(cuda):
    """One byte of a stored chunk's bitstream flipped: the card's decode
    differs from the stored codes and assemble refuses the chunk."""
    srv, cid, *_ = _mixed_width_server(cuda)
    st = srv.contexts[cid]
    c = sorted(st.encoded)[1]
    ek, ev, qk, qv = st.encoded[c]
    streams = ek.streams.copy()
    streams[0, 0] ^= 0xFF
    st.encoded[c] = (dataclasses.replace(ek, streams=streams), ev, qk, qv)
    with pytest.raises(RuntimeError, match="bitstream corruption"):
        srv.assemble(st, [c])
    st.encoded[c] = (ek, ev, qk, qv)
    srv.assemble(st, [c])


# ---------------------------------------------------------------------------
# the fleet stack: the planner MLP on the card
# ---------------------------------------------------------------------------

def _fleet_fingerprint(report):
    """The tuple of tests/test_simcore.py::_fleet_fingerprint."""
    return [(r.spec.arrival_s, r.ttft_s, r.ttlt_s, r.energy_j,
             r.uplink_share,
             r.compute_wait_s, r.bytes_streamed, r.policy,
             tuple(sorted(r.stage_shares.items())))
            for r in report.records]


def test_standalone_fleet_plans_on_card_deterministically(cuda, monkeypatch):
    """A standalone ServingCluster (N 16, 2 devices, WFQ, a memory budget
    under the decoding fleet's residency) builds its planner on the card
    by default, and two runs of the same trace give the same fingerprint."""
    from repro_torch.configs import get_config
    from repro_torch.core import baselines as TB
    from repro_torch.core.costs import MemoryModel, RunQueueModel
    from repro_torch.serving.cluster import ServingCluster
    from repro_torch.serving.decode import DecodeConfig
    from repro_torch.serving.traffic import TrafficProfile, generate_trace

    cfg = get_config("sparkv-qwen3-4b")
    monkeypatch.delitem(TB._PRED_CACHE, (cfg.name, "jetson-orin"),
                        raising=False)
    specs = generate_trace(TrafficProfile(
        rate_rps=2.0, arrival="poisson", n_devices=2, max_context=2048,
        out_len_mix=((24, 1.0),)), 16, seed=5)
    reports = []
    for _ in range(2):
        cluster = ServingCluster(
            cfg, SparKVConfig(scheduler_mode="engine"), "jetson-orin",
            "campus-wifi", n_devices=2, max_concurrency=8,
            run_queue=RunQueueModel(2, "wfq"),
            decode=DecodeConfig(max_batch=4),
            memory=MemoryModel(capacity_bytes=4e8))
        reports.append(cluster.run(specs))
    assert TB._PRED_CACHE[(cfg.name, "jetson-orin")].device.type == "cuda"
    assert len(reports[0].records) == 16
    assert reports[0].memory["n_evictions"] > 0
    assert _fleet_fingerprint(reports[0]) == _fleet_fingerprint(reports[1])


def test_serve_fleet_on_a_card_server_plans_on_card(cuda, monkeypatch):
    """serve_fleet on a server built for the card trains the fleet's
    planner there."""
    from repro_torch.core import baselines as TB
    from repro_torch.core.costs import RunQueueModel

    cfg = get_smoke("sparkv-qwen3-4b", layers=3, d_model=64, heads=4,
                    d_ff=128, vocab=256)
    model = build_model(cfg)
    srv = SparKVServer(model, model.init(0, device=cuda),
                       SparKVConfig(chunk_tokens=32, q_block=16, kv_block=16,
                                    quant_group=32),
                       chunk_tokens=32, device=cuda)
    cid = srv.register_context(
        np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, 96)))
    key = (cfg.name, srv.profile)
    monkeypatch.delitem(TB._PRED_CACHE, key, raising=False)
    jobs = [(cid, 0.3 * i, p) for i, p in enumerate(
        ["sparkv", "strong_hybrid", "cachegen", "local_prefill"] * 2)]
    rep = srv.serve_fleet(jobs, run_queue=RunQueueModel(2, "wfq"))
    assert len(rep.records) == len(jobs)
    assert TB._PRED_CACHE[key].device.type == "cuda"


# -------------------------------------------------- training and Whisper


def test_train_step_on_card_matches_cpu(cuda):
    """One build_train_step step of the qwen2.5-3b smoke config on the
    card against the CPU, fp32 with TF32 off, from the same params and
    batch. Grads differ by fp32 summation order, plus the odd element
    whose cotangent rounds to the other bf16 neighbour at a block's
    gradient barrier: grads within 1e-3 of each leaf's largest, the loss
    within 1e-5. At the first Adam step every element moves by about
    +-lr, so an element whose tiny grad flips sign lands 2 * lr away:
    params within 2 * lr + 1e-6."""
    from repro_torch.configs import TrainConfig
    from repro_torch.training.trainer import (build_train_step, data_batch,
                                              value_and_grad)
    from repro_torch.tree import leaves, tree_map
    model = build_model(get_smoke("qwen2.5-3b"))
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4)
    params = tree_map(lambda t: t.float(), model.init(0, device="cpu"))
    batch = data_batch(model.cfg, tcfg, 0, 4, 32, device="cpu")
    gpu = lambda tree: tree_map(lambda t: t.to(cuda), tree)
    _, cg = value_and_grad(model.loss, params, batch)
    _, gg = value_and_grad(model.loss, gpu(params), gpu(batch))
    for a, b in zip(leaves(gg), leaves(cg)):
        bound = 1e-3 * max(float(b.abs().max()), 1e-3)
        assert float((a.cpu() - b).abs().max()) <= bound
    step, opt = build_train_step(model, tcfg)
    cp, _, cm = step(tree_map(torch.clone, params), opt.init(params), batch)
    gparams = gpu(params)
    gp, gst, gm = step(gparams, opt.init(gparams), gpu(batch))
    assert gst.count.device.type == cuda.type
    assert abs(float(gm["loss"]) - float(cm["loss"])) < 1e-5
    for a, b in zip(leaves(gp), leaves(cp)):
        assert float((a.cpu() - b).abs().max()) <= 2 * 1e-3 + 1e-6


def test_whisper_decode_on_card_matches_cpu(cuda):
    """The whisper smoke model's prefill and 8 decode steps on the card
    against the CPU, fp32 with TF32 off: logits within 1e-5 (fp32
    summation order; logits of magnitude ~0.1)."""
    from repro_torch.tree import tree_map
    model = build_model(get_smoke("whisper-tiny"))
    cfg = model.cfg
    params = tree_map(lambda t: t.float() + 0.01 * torch.randn(
        t.shape, generator=torch.Generator().manual_seed(t.numel())),
        model.init(0, device="cpu"))
    gparams = tree_map(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.normal(size=(2, 40, cfg.d_model))
                              .astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 8)))
    caches = []
    for p, dev in ((params, "cpu"), (gparams, cuda)):
        pf = model.prefill(p, {"frames": frames.to(dev)})
        cache = dict(model.init_cache(2, 40, device=dev), **pf)
        cache = dict(cache, self_k=cache["self_k"].float(),
                     self_v=cache["self_v"].float())
        out = []
        for i in range(8):
            lg, cache = model.decode_step(p, cache, tokens[:, i].to(dev), i)
            out.append(lg.cpu())
        caches.append(out)
    for a, b in zip(*caches):
        assert torch.allclose(b, a, atol=1e-5, rtol=0)


def test_checkpoint_from_card_restores_on_cpu(cuda, tmp_path):
    """A train state saved from card tensors (bf16 params, fp32 moments,
    int32 count) restores on the CPU bit for bit, and back onto the
    card."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import TrainConfig
    from repro_torch.training.optimizer import AdamW
    from repro_torch.tree import leaves, tree_map
    model = build_model(get_smoke("whisper-tiny"))
    params = model.init(0, device=cuda)
    opt = AdamW(TrainConfig()).init(params)
    opt = opt._replace(m=tree_map(lambda t: torch.randn_like(t), opt.m),
                       count=opt.count + 3)
    state = {"params": params, "opt": opt}
    cm = CheckpointManager(str(tmp_path))
    cm.save(state, 1)
    cm.wait()
    like = tree_map(lambda t: t.cpu(), state)
    out = cm.restore(1, like=like, device="cpu")
    back = cm.restore(1, like=state, device=cuda)
    for a, b, c in zip(leaves(out), leaves(state), leaves(back)):
        assert a.device.type == "cpu" and c.device.type == cuda.type
        assert a.dtype == b.dtype and torch.equal(a, b.cpu())
        assert torch.equal(c, b)


def test_jit_train_step_on_one_rank_nccl_mesh(cuda):
    """The qwen2.5-3b smoke config through jit_train_step on a (1, 1)
    mesh of a one-rank NCCL group against build_train_step on the card,
    2 steps from the same fp32 params and batches: a one-device mesh runs
    the same kernels, so losses and grad norms within 1e-6 and params
    within 1e-6 of each leaf's largest (expected bit-equal)."""
    import torch.distributed as dist
    from repro_torch.configs import TrainConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.training.trainer import (build_train_step, data_batch,
                                              jit_train_step, shard_tree)
    from repro_torch.tree import leaves, tree_map
    if dist.is_initialized():
        pytest.skip("a process group is already running in this process")
    model = build_model(get_smoke("qwen2.5-3b"))
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4)
    init = tree_map(lambda t: t.float(), model.init(0, device=cuda))
    batches = [data_batch(model.cfg, tcfg, s, 4, 32, device=cuda)
               for s in range(2)]
    step, opt = build_train_step(model, tcfg)
    p = tree_map(torch.clone, init)
    st = opt.init(p)
    want = []
    for b in batches:
        p, st, m = step(p, st, b)
        want.append((float(m["loss"]), float(m["grad_norm"])))
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_local_mesh((1, 1), device="cuda")
        rules = make_rules(model.cfg, mesh)
        sstep, sopt = jit_train_step(model, tcfg, rules, model.input_pspecs(
            ShapeConfig("t", "train", 32, 4), rules))
        q = shard_tree(tree_map(torch.clone, init),
                       model.param_shardings(rules))
        sst = sopt.init(q)
        for b, (loss, gn) in zip(batches, want):
            q, sst, m = sstep(q, sst, b)
            assert abs(float(m["loss"]) - loss) <= 1e-6
            assert abs(float(m["grad_norm"]) - gn) <= 1e-6
        assert type(q["emb"]).__name__ == "DTensor"
        for a, b in zip(leaves(q), leaves(p)):
            a = a.to_local()
            assert a.device.type == "cuda"
            bound = 1e-6 * max(float(b.abs().max()), 1e-3)
            assert float((a - b).abs().max()) <= bound
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["sparkv-qwen3-4b", "mamba2-130m"])
def test_prefill_and_decode_on_one_rank_nccl_mesh(cuda, arch, monkeypatch):
    """chip_smoke's path P at smoke size: a prefill and 4 decode steps
    over DTensors on a (1, 1) mesh of a one-rank NCCL group (the dry
    run's prefill and weight-stationary rules) against the plain port on
    the card, from the same fp32 params and tokens: logits and caches
    within 1e-6 of the plain port with its decode attention on the eager
    path that DTensors take (a one-device mesh runs the same kernels),
    and the decode logits within 1e-5 of the largest logit (1 at least)
    of the plain port as the card runs it, through the flash-decode
    kernel."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.api import lay_out
    from repro_torch.training.trainer import partitioned, shard_tree
    from repro_torch.tree import leaves, tree_map
    if dist.is_initialized():
        pytest.skip("a process group is already running in this process")
    model = build_model(get_smoke(arch))
    params = tree_map(lambda t: t.float(), model.init(0, device=cuda))
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, 512, size=(2, 40)), device=cuda)
    toks = [torch.as_tensor(t, device=cuda)
            for t in rng.integers(0, 512, size=(4, 2))]

    def serve(p, rp=None, rd=None):
        lay = (lambda t, ax, r: lay_out(t, ax, r)) if rp else \
            (lambda t, ax, r: t)
        with torch.no_grad(), partitioned(rp):
            x = rp.distribute(tokens, ("batch", None)) if rp else tokens
            logits, pre = lay(model.prefill(p, {"tokens": x}),
                              model.prefill_out_axes(), rp)
        out = [logits]
        with torch.no_grad(), partitioned(rd):
            cache = lay(model.decode_cache(tree_map(torch.clone, pre), rd),
                        model.cache_axes(), rd)
            for i, t in enumerate(toks):
                t = rd.distribute(t, ("batch",)) if rd else t
                lg, cache = model.decode_step(p, cache, t, 40 + i)
                out.append(lg)
        return out + leaves(pre) + leaves(cache)

    kernel = serve(params)
    monkeypatch.setattr(T, "_kernel_path", lambda *a: False)
    want = serve(params)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_local_mesh((1, 1), device="cuda")
        rp = make_rules(model.cfg, mesh)
        rd = make_rules(model.cfg, mesh, weight_stationary=True)
        got = serve(shard_tree(params, model.param_shardings(rp)), rp, rd)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert type(a).__name__ == "DTensor"
            a = a.to_local()
            assert a.device.type == "cuda"
            assert float((a.float() - b.float()).abs().max()) <= 1e-6
        # the kernel sums the fp32 scores and P V in another order than
        # the eager path's chunks and merge (fp32 throughout, so no score
        # or p is rounded to a narrower type): each attention output moves
        # by at most about n_keys x 2^-24 of its scale (44 keys: 2.6e-6),
        # which the smoke model's normed layers carry to the logits at that
        # relative size; 1e-5 leaves about 4x on that sum
        for a, b in zip(got[1:1 + len(toks)], kernel[1:1 + len(toks)]):
            bound = 1e-5 * max(float(b.abs().max()), 1.0)
            assert float((a.to_local() - b).abs().max()) <= bound
    finally:
        dist.destroy_process_group()
