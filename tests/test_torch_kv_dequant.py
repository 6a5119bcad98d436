"""The port's KV dequantization (plain versions, oracles, wrappers)
against the JAX package's Pallas kernels on the same inputs. The CUDA
kernels are held against these plain versions on the card by
tests/test_torch_cuda.py, which imports no JAX."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.compression.quantize import quantize  # noqa: E402
from repro.kernels.kv_dequant import kernel as JK  # noqa: E402
from repro.kernels.kv_dequant import ops as JO  # noqa: E402
from repro.kernels.kv_dequant import ref as JR  # noqa: E402
from repro_torch.compression.quantize import \
    QuantizedTensor as TQuantizedTensor  # noqa: E402
from repro_torch.kernels.kv_dequant import kernel as TK  # noqa: E402
from repro_torch.kernels.kv_dequant import ops as TO  # noqa: E402
from repro_torch.kernels.kv_dequant import ref as TR  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bits(a):
    """Bit pattern of a float array (fp32 or bf16) as unsigned ints."""
    a = np.asarray(a)
    return a.view(np.uint32 if a.dtype.itemsize == 4 else np.uint16)


def _tbits(t):
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


def _assert_bit_equal(jax_out, torch_out):
    assert jax_out.shape == tuple(torch_out.shape)
    assert np.array_equal(_bits(jax_out), _tbits(torch_out))


def _single_case(rng, n, width, group, bits):
    codes = rng.integers(0, 1 << bits, size=(n, width)).astype(np.uint8)
    g = width // group
    scales = rng.uniform(0.01, 0.2, (n, g)).astype(np.float32)
    zeros = rng.normal(size=(n, g)).astype(np.float32)
    return codes, scales, zeros


def _mixed_case(rng, n, width, group):
    g = width // group
    bits = rng.choice([3, 4, 5, 6, 8], size=(n, 1)).astype(np.int32)
    codes = (rng.integers(0, 256, size=(n, width)) %
             (1 << bits)).astype(np.uint8)
    spans = rng.uniform(0.1, 4.0, (n, g)).astype(np.float32)
    zeros = rng.normal(size=(n, g)).astype(np.float32)
    return codes, spans, zeros, bits


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# the cases of tests/test_kernels.py: test_kv_dequant_vs_ref and
# test_kv_dequant_ragged_grid (5-bit codes)
SINGLE = [(64, 128, 64, 5), (100, 512, 64, 4), (7, 256, 128, 8),
          (1024, 128, 32, 3), (37, 128, 64, 5), (255, 256, 64, 5),
          (129, 128, 32, 5), (5, 192, 64, 5)]
MIXED = [(64, 128, 64), (53, 256, 64), (7, 128, 32)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,width,group,bits", SINGLE)
def test_kv_dequant_plain_matches_pallas(n, width, group, bits, dtype, rng):
    """Bit-equal to the Pallas kernel (interpret mode) in fp32 and bf16:
    both round code * scale + zero once (fma), then to bf16 by RNE."""
    jdt, tdt = DTYPES[dtype]
    codes, scales, zeros = _single_case(rng, n, width, group, bits)
    jout = JK.kv_dequant(jnp.asarray(codes), jnp.asarray(scales),
                         jnp.asarray(zeros), group=group, interpret=True,
                         out_dtype=jdt)
    tout = TK.kv_dequant_plain(*_t(codes, scales, zeros), group=group,
                               out_dtype=tdt)
    _assert_bit_equal(np.asarray(jout), tout)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,width,group", MIXED)
def test_kv_dequant_mixed_plain_matches_pallas(n, width, group, dtype, rng):
    """Bit-equal to the mixed Pallas kernel: IEEE fp32 span / (2^b - 1),
    then one fma."""
    jdt, tdt = DTYPES[dtype]
    codes, spans, zeros, bits = _mixed_case(rng, n, width, group)
    jout = JK.kv_dequant_mixed(jnp.asarray(codes), jnp.asarray(spans),
                               jnp.asarray(zeros), jnp.asarray(bits),
                               group=group, interpret=True, out_dtype=jdt)
    tout = TK.kv_dequant_mixed_plain(*_t(codes, spans, zeros, bits),
                                     group=group, out_dtype=tdt)
    _assert_bit_equal(np.asarray(jout), tout)


@pytest.mark.parametrize("n,width,group,bits", SINGLE[:4])
def test_kv_dequant_refs_match(n, width, group, bits, rng):
    """The port's oracles equal the reference oracles bit for bit (both
    multiply, then add); the fused plain versions stay within atol 1e-6
    of them, the bound tests/test_kernels.py holds the Pallas kernel to."""
    codes, scales, zeros = _single_case(rng, n, width, group, bits)
    jref = JR.kv_dequant_ref(jnp.asarray(codes), jnp.asarray(scales),
                             jnp.asarray(zeros), group=group,
                             out_dtype=jnp.float32)
    tref = TR.kv_dequant_ref(*_t(codes, scales, zeros), group=group,
                             out_dtype=torch.float32)
    _assert_bit_equal(np.asarray(jref), tref)
    plain = TK.kv_dequant_plain(*_t(codes, scales, zeros), group=group,
                                out_dtype=torch.float32)
    np.testing.assert_allclose(plain.numpy(), tref.numpy(), atol=1e-6)

    mcodes, spans, mzeros, mbits = _mixed_case(rng, n, width, group)
    jm = JR.kv_dequant_mixed_ref(*map(jnp.asarray,
                                      (mcodes, spans, mzeros, mbits)),
                                 group=group, out_dtype=jnp.float32)
    tm = TR.kv_dequant_mixed_ref(*_t(mcodes, spans, mzeros, mbits),
                                 group=group, out_dtype=torch.float32)
    _assert_bit_equal(np.asarray(jm), tm)


def _port_qt(qt) -> TQuantizedTensor:
    return TQuantizedTensor(**{f.name: getattr(qt, f.name)
                               for f in dataclasses.fields(qt)})


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dequantize_chunks_match_reference(dtype, rng):
    """dequantize_chunk / dequantize_chunks_mixed on quantize() outputs of
    heterogeneous widths and ragged sizes (tests/test_kernels.py:194-213)
    equal the reference's, chunk by chunk, bit for bit."""
    jdt, tdt = DTYPES[dtype]
    shapes = [(64, 48), (7, 33), (128, 64), (19, 5)]
    widths = [8, 3, 5, 4]
    qts = [quantize(rng.normal(size=s).astype(np.float32), b, 64)
           for s, b in zip(shapes, widths)]
    pqts = [_port_qt(q) for q in qts]
    jm = JO.dequantize_chunks_mixed(qts, out_dtype=jdt)
    tm = TO.dequantize_chunks_mixed(pqts, out_dtype=tdt, device="cpu")
    for qt, pqt, j, t in zip(qts, pqts, jm, tm):
        _assert_bit_equal(np.asarray(j), t)
        js = JO.dequantize_chunk(qt, out_dtype=jdt)
        ts = TO.dequantize_chunk(pqt, out_dtype=tdt, device="cpu")
        _assert_bit_equal(np.asarray(js), ts)
        if dtype == "float32":
            # one mixed launch == the per-chunk launch, in the port too
            assert torch.equal(t, ts)


def test_dequantize_chunks_mixed_legacy_spans(rng):
    """Pre-spans tensors (spans=None) rebuild spans from scales
    (tests/test_kernels.py:215-223), on both sides."""
    qt = quantize(rng.normal(size=(32, 32)).astype(np.float32), 4, 64)
    legacy = dataclasses.replace(qt, spans=None)
    (j,) = JO.dequantize_chunks_mixed([legacy], out_dtype=jnp.float32)
    (t,) = TO.dequantize_chunks_mixed([_port_qt(legacy)],
                                      out_dtype=torch.float32, device="cpu")
    _assert_bit_equal(np.asarray(j), t)
    single = TO.dequantize_chunk(_port_qt(qt), out_dtype=torch.float32,
                                 device="cpu")
    assert torch.equal(t, single)


def test_wrappers_dispatch_on_device(rng):
    """CPU tensors take the plain version and count no launch; the CUDA
    launcher refuses a CPU tensor instead of falling back."""
    codes, scales, zeros = _single_case(rng, 8, 128, 64, 5)
    before = dict(TK.LAUNCHES)
    out = TO.kv_dequant(*_t(codes, scales, zeros), group=64,
                        out_dtype=torch.float32)
    assert out.device.type == "cpu" and TK.LAUNCHES == before
    with pytest.raises(ValueError):
        TK.kv_dequant(*_t(codes, scales, zeros), group=64)
    with pytest.raises(RuntimeError):
        TO.dequantize_chunk(_port_qt(quantize(
            rng.normal(size=(4, 64)).astype(np.float32), 5, 64)))
