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


# batches of chunk tensors written into a K and a V cache of 6 slots of
# 4096 values: (group, mixed form, entries of (cache, slot, values,
# bits)). Value counts off the 16-code run and the group, several widths,
# slots left unwritten, tails of slots left unwritten.
SLOTS, SLOT = 6, 4096
BATCHES = {
    "uniform_ragged": (64, False, [("k", 0, 1000, 5), ("v", 0, 1000, 5),
                                   ("k", 2, 33, 5), ("v", 3, 64, 5),
                                   ("k", 4, 17, 5), ("v", 5, 4096, 5),
                                   ("k", 5, 1, 5)]),
    "uniform_group32": (32, False, [("k", 1, 100, 4), ("v", 1, 4096, 4),
                                    ("v", 4, 31, 4)]),
    "mixed_ragged": (64, True, [("k", 0, 1000, 3), ("v", 0, 1000, 8),
                                ("k", 1, 4096, 5), ("v", 2, 65, 4),
                                ("k", 3, 7, 6), ("v", 4, 4096, 5)]),
    "mixed_group32": (32, True, [("k", 0, 48, 4), ("k", 2, 4000, 6),
                                 ("v", 2, 4000, 5), ("v", 5, 129, 3)]),
    "mixed_one_width": (64, True, [("v", 1, 4096, 5), ("k", 3, 333, 5)]),
}
SENTINEL = -7.25


def _batch_case(rng, case):
    group, mixed, entries = BATCHES[case]
    qts = [quantize((3 * rng.normal(size=n)).astype(np.float32), b, group)
           for _, _, n, b in entries]
    return group, mixed, entries, qts


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(BATCHES))
def test_batch_plain_writes_reference_values_at_their_slots(case, dtype,
                                                            rng):
    """One staged batch through the table form's plain version, written
    into K and V caches, equals the reference's dequantize_chunk (uniform)
    or dequantize_chunks_mixed (mixed), in interpret mode, at each chunk's
    slot, bit for bit; every other cache position keeps its value."""
    jdt, tdt = DTYPES[dtype]
    group, mixed, entries, qts = _batch_case(rng, case)
    cache = {c: torch.full((SLOTS, SLOT), SENTINEL, dtype=tdt) for c in "kv"}
    want = {c: _tbits(cache[c]).copy() for c in "kv"}
    if mixed:
        jouts = JO.dequantize_chunks_mixed(qts, out_dtype=jdt)
    else:
        jouts = [JO.dequantize_chunk(q, out_dtype=jdt) for q in qts]
    for (c, slot, n, _), j in zip(entries, jouts):
        want[c][slot, :n] = _bits(j).reshape(-1)
    TO.dequantize_into([_port_qt(q) for q in qts],
                       [cache[c][slot] for c, slot, _, _ in entries],
                       mixed=mixed)
    for c in "kv":
        assert np.array_equal(_tbits(cache[c]), want[c])


def test_stage_builds_the_entry_table(rng):
    """Entries follow each other as whole groups: first groups, value
    counts, destination addresses and (mixed) bit-widths in the table;
    the codes, then zeros up to the group's end; spans or steps."""
    for case in ("uniform_ragged", "mixed_ragged"):
        group, mixed, entries, qts = _batch_case(rng, case)
        cache = {c: torch.zeros((SLOTS, SLOT)) for c in "kv"}
        dests = [cache[c][slot] for c, slot, _, _ in entries]
        b = TO.stage([_port_qt(q) for q in qts], dests, mixed=mixed)
        n = np.array([e[2] for e in entries])
        first = np.concatenate([[0], np.cumsum(-(-n // group))[:-1]])
        assert np.array_equal(b.table.numpy(), b.rows)
        assert np.array_equal(b.rows[:, 0], first)
        assert np.array_equal(b.rows[:, 1], n)
        assert b.rows[:, 2].tolist() == [d.data_ptr() for d in dests]
        assert b.rows[:, 3].tolist() == ([q.bits for q in qts] if mixed
                                         else [0] * len(qts))
        assert b.params.numel() == first[-1] + -(-n[-1] // group)
        for q, f, k in zip(qts, first, n):
            span = -(-k // group)
            codes = b.codes[f * group:(f + span) * group].numpy()
            assert np.array_equal(codes[:k], q.codes)
            assert not codes[k:].any()
            assert np.array_equal(b.params[f:f + span].numpy(),
                                  q.spans if mixed else q.scales)
            assert np.array_equal(b.zeros[f:f + span].numpy(), q.zeros)


def test_batch_refuses_a_table_that_misses_its_destinations(rng):
    """The plain version checks each table address against its
    destination; the CUDA launcher refuses a batch on the CPU."""
    group, mixed, entries, qts = _batch_case(rng, "uniform_group32")
    cache = torch.zeros((SLOTS, SLOT))
    b = TO.stage([_port_qt(q) for q in qts],
                 [cache[slot] for _, slot, _, _ in entries], mixed=mixed)
    with pytest.raises(ValueError):
        TK.dequant_batch(b)
    b.dests = b.dests[::-1]
    with pytest.raises(ValueError):
        TK.dequant_batch_plain(b)
