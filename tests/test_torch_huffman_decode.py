"""The port's Huffman decode against the JAX package's decoder
(``repro.compression.huffman``, numpy): the CPU dispatch of
``kernels/huffman_decode/ops.py``, and what the CUDA kernel reads, built on
the host: the packed buffer's sections, the per-stream segments and the
shared-memory table from the code lengths. The kernel itself is held
against the decoder on the card by tests/test_torch_cuda.py."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.compression import huffman as RH  # noqa: E402
from repro_torch.kernels.huffman_decode import kernel as K  # noqa: E402
from repro_torch.kernels.huffman_decode import ops as O  # noqa: E402
from torch_huffman_cases import HUFFMAN_CASES, huffman_symbols  # noqa: E402


def _encode(name):
    symbols, alphabet, streams = huffman_symbols(name)
    return RH.encode(symbols, alphabet, n_streams=streams), symbols


@pytest.mark.parametrize("huffman_case", HUFFMAN_CASES)
def test_packed_table_is_the_reference_table(huffman_case):
    """The kernel's table, built from the code lengths alone, equals
    ``HuffmanCode.decode_table()`` entry for entry."""
    enc, _ = _encode(huffman_case)
    sym, ln = enc.code.decode_table()
    assert np.array_equal(K.packed_table(enc.code.lengths),
                          sym | (ln << 8))
    if huffman_case == "max-len-16":
        assert enc.code.lengths.max() == RH.MAX_LEN


@pytest.mark.parametrize("huffman_case", HUFFMAN_CASES)
def test_segments_are_the_prefix_sums_of_the_counts(huffman_case):
    enc, symbols = _encode(huffman_case)
    seg = K.segments(enc.n_per_stream)
    n = enc.n_per_stream
    assert seg.dtype == np.int64 and seg.shape == (len(n), 2)
    assert np.array_equal(seg[:, 1], n)
    assert np.array_equal(seg[:, 0], np.concatenate([[0], np.cumsum(n)[:-1]]))
    # each stream's segment of the flat order holds that stream's symbols
    per = -(-len(symbols) // len(n)) if len(symbols) else 0
    for r, (start, count) in enumerate(seg):
        assert np.array_equal(symbols[start:start + count],
                              symbols[r * per:r * per + count])


@pytest.mark.parametrize("huffman_case", HUFFMAN_CASES)
def test_packed_buffer_decodes_to_the_reference(huffman_case):
    """The case and a second tensor (another alphabet) packed into one
    buffer of stale bytes: the head holds the layout's rows; every section
    lies on a 16-byte boundary, inside the buffer and apart from the
    others; each holds its tensor's code lengths, stream rows (whole lines
    and one zero line more) and segment pairs; and the reference's decoder,
    given the rows and the counts read back from the buffer, gives the
    tensor's codes."""
    enc, symbols = _encode(huffman_case)
    other = RH.encode(np.arange(777, dtype=np.uint16) % 9, 16, n_streams=5)
    encs = [enc, other]
    lay = K.layout(encs)
    h = np.full(lay.nbytes, 0xA5, np.uint8)
    K.pack(encs, lay, h)
    head = 8 * K._COLS * len(encs)
    assert np.array_equal(h[:head].view(np.int64).reshape(lay.rows.shape),
                          lay.rows)
    spans = [(0, head)]
    outs = []
    for e, row in zip(encs, lay.rows):
        s, nbytes = e.streams.shape
        assert row[K.N_STREAMS] == s and row[K.N_ALPHA] == len(e.code.lengths)
        assert row[K.STRIDE] % K.LINE == 0
        assert row[K.STRIDE] >= nbytes + K.LINE
        for col in (K.STREAMS, K.LENS, K.SEGS, K.OUT):
            assert row[col] % 16 == 0
        spans += [(row[K.LENS], row[K.LENS] + row[K.N_ALPHA]),
                  (row[K.STREAMS], row[K.STREAMS] + s * row[K.STRIDE]),
                  (row[K.SEGS], row[K.SEGS] + 16 * s)]
        outs.append((row[K.OUT], row[K.OUT] + e.n_total))
        assert np.array_equal(h[row[K.LENS]:row[K.LENS] + row[K.N_ALPHA]],
                              e.code.lengths)
        rows = h[row[K.STREAMS]:row[K.STREAMS] + s * row[K.STRIDE]] \
            .reshape(s, -1)
        assert np.array_equal(rows[:, :nbytes], e.streams)
        assert not rows[:, nbytes:].any()
        segs = h[row[K.SEGS]:row[K.SEGS] + 16 * s].view(np.int64)
        assert np.array_equal(segs.reshape(s, 2), K.segments(e.n_per_stream))
        back = dataclasses.replace(e, streams=rows,
                                   n_per_stream=segs.reshape(s, 2)[:, 1])
        assert np.array_equal(RH.decode(back), RH.decode(e))
    for sections, size in ((spans, lay.nbytes), (outs, lay.out_bytes)):
        sections.sort()
        assert all(a[1] <= b[0] for a, b in zip(sections, sections[1:]))
        assert sections[-1][1] <= size
    assert lay.sizes == [e.n_total for e in encs]
    assert np.array_equal(RH.decode(enc), symbols)


@pytest.mark.parametrize("huffman_case", HUFFMAN_CASES)
def test_cpu_dispatch_is_the_reference_decoder(huffman_case):
    enc, symbols = _encode(huffman_case)
    before = K.LAUNCHES["huffman_decode"]
    got = O.decode([enc, enc], "cpu")
    assert len(got) == 2
    for g in got:
        assert g.dtype == np.uint16 and np.array_equal(g, RH.decode(enc))
        assert np.array_equal(g, symbols)
    assert K.LAUNCHES["huffman_decode"] == before


def _code(lengths):
    return RH.HuffmanCode(lengths=np.asarray(lengths, np.int32),
                          codes=np.zeros(len(lengths), np.uint16))


@pytest.mark.parametrize("change,match", [
    (lambda e: dataclasses.replace(e, code=_code(np.ones(257, np.int32))),
     "alphabets of 1 to 256"),
    (lambda e: dataclasses.replace(e, code=_code([17, 1])), r"\[0, 16\]"),
    (lambda e: dataclasses.replace(e, code=_code([1, 1, 1])), "Kraft"),
    (lambda e: dataclasses.replace(e, n_total=e.n_total + 1),
     "sum to the tensor's"),
    (lambda e: dataclasses.replace(e, n_per_stream=e.n_per_stream[:-1]),
     "one non-negative symbol count a stream"),
    (lambda e: dataclasses.replace(e, streams=e.streams.astype(np.int16)),
     "uint8"),
], ids=["alphabet-257", "length-17", "kraft", "count-sum", "stream-counts",
        "stream-dtype"])
def test_refuses_what_the_kernel_cannot_take(change, match):
    """The launcher's checks need no card: they run before any copy."""
    enc = RH.encode(np.arange(300, dtype=np.uint16) % 7, 8, n_streams=4)
    K.layout([enc])
    with pytest.raises(ValueError, match=match):
        K.layout([change(enc)])


def test_refuses_other_devices():
    enc = RH.encode(np.arange(10, dtype=np.uint16), 16, n_streams=2)
    with pytest.raises(ValueError, match="no huffman_decode for device"):
        O.decode([enc], "meta")
