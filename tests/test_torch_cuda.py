"""The port on the card: each CUDA kernel against its plain version, and
the serving path through the kernels. Imports no JAX, so it runs where
only PyTorch is installed; without a card every case skips.

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import SparKVConfig, get_smoke  # noqa: E402
from repro_torch.kernels.kv_dequant import kernel as K  # noqa: E402
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


@pytest.mark.parametrize("sched", ["uniform", "attention"])
def test_serving_on_card_goes_through_kernels(cuda, sched):
    """A small server on the card launches the kernels for every streamed
    chunk, and assembles exactly the cache a CPU server assembles from the
    same stored context with the plain versions."""
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
        assert K.LAUNCHES == {"kv_dequant": 2 * n, "kv_dequant_mixed": 0}
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
