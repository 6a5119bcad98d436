"""Canonical Huffman codec with SIMD-style interleaved multi-stream decode.

Real bitstreams (this is what goes over the simulated wire, and roundtrip
exactness is tested). Sequential Huffman decode is unvectorizable, so —
like production entropy coders (interleaved rANS) — we split symbols into S
independent streams decoded in lockstep with numpy gathers: the decode loop
runs max-symbols-per-stream iterations, each vectorized across streams.

Max code length is capped at MAX_LEN (table-driven decode, 2^16 entries);
if the unrestricted Huffman tree exceeds it, counts are flattened toward
uniform until it fits (tiny rate loss, recorded by the caller via actual
encoded size).
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

MAX_LEN = 16


def _code_lengths(counts: np.ndarray) -> np.ndarray:
    """Huffman code lengths per symbol (0 for absent symbols)."""
    n = len(counts)
    active = [int(s) for s in np.nonzero(counts)[0]]
    if not active:
        return np.zeros(n, np.int32)
    if len(active) == 1:
        out = np.zeros(n, np.int32)
        out[active[0]] = 1
        return out
    flat = counts.astype(np.float64)
    for _ in range(32):
        heap = [(float(flat[s]), i, (s,)) for i, s in enumerate(active)]
        heapq.heapify(heap)
        uid = len(heap)
        depth = {s: 0 for s in active}
        while len(heap) > 1:
            c1, _, s1 = heapq.heappop(heap)
            c2, _, s2 = heapq.heappop(heap)
            for s in s1 + s2:
                depth[s] += 1
            heapq.heappush(heap, (c1 + c2, uid, s1 + s2))
            uid += 1
        lens = np.zeros(n, np.int32)
        for s, d in depth.items():
            lens[s] = d
        if lens.max() <= MAX_LEN:
            return lens
        # flatten the distribution and retry
        flat = np.sqrt(flat) * flat.sum() / np.maximum(
            np.sqrt(flat).sum(), 1e-9)
        flat[np.asarray(active)] = np.maximum(flat[np.asarray(active)], 1.0)
    raise RuntimeError("could not limit Huffman code length")


def _canonical_codes(lens: np.ndarray) -> np.ndarray:
    """Canonical code values (uint16) from lengths."""
    n = len(lens)
    codes = np.zeros(n, np.uint16)
    code = 0
    prev_len = 0
    order = sorted((l, s) for s, l in enumerate(lens) if l > 0)
    for l, s in order:
        code <<= (l - prev_len)
        codes[s] = code
        code += 1
        prev_len = l
    return codes


@dataclasses.dataclass
class HuffmanCode:
    lengths: np.ndarray    # (n_symbols,) int32
    codes: np.ndarray      # (n_symbols,) uint16

    @classmethod
    def from_counts(cls, counts: np.ndarray) -> "HuffmanCode":
        lens = _code_lengths(np.asarray(counts))
        return cls(lengths=lens, codes=_canonical_codes(lens))

    def table_bytes(self) -> int:
        return len(self.lengths)  # one length byte per symbol (canonical)

    def decode_table(self):
        """(symbol, length) uint16 arrays indexed by 16-bit window."""
        sym = np.zeros(1 << MAX_LEN, np.uint16)
        ln = np.zeros(1 << MAX_LEN, np.uint16)
        for s, l in enumerate(self.lengths):
            l = int(l)
            if l == 0:
                continue
            prefix = int(self.codes[s]) << (MAX_LEN - l)
            span = 1 << (MAX_LEN - l)
            sym[prefix:prefix + span] = s
            ln[prefix:prefix + span] = l
        return sym, ln


@dataclasses.dataclass
class EncodedChunk:
    streams: np.ndarray        # (S, max_bytes) uint8
    bit_lengths: np.ndarray    # (S,) int64
    n_per_stream: np.ndarray   # (S,) int64 symbol counts
    n_symbols_alphabet: int
    code: HuffmanCode
    n_total: int

    def payload_bytes(self) -> int:
        return int(np.sum((self.bit_lengths + 7) // 8)) \
            + self.code.table_bytes() + 4 * len(self.bit_lengths)


def encode(symbols: np.ndarray, n_alphabet: int,
           n_streams: int = 64) -> EncodedChunk:
    symbols = np.asarray(symbols, np.uint16).reshape(-1)
    n = len(symbols)
    counts = np.bincount(symbols, minlength=n_alphabet)
    code = HuffmanCode.from_counts(counts)

    s = min(n_streams, max(1, n))
    per = -(-n // s)
    pad = s * per - n
    syms = np.concatenate([symbols, np.zeros(pad, np.uint16)])
    syms = syms.reshape(s, per)
    n_per = np.full(s, per, np.int64)
    if pad:
        n_per[-1] -= 0  # padding symbols live in the last rows
        full_rows = n // per
        n_per[:] = per
        n_per[full_rows] = n - full_rows * per if full_rows < s else per
        n_per[full_rows + 1:] = 0

    lens = code.lengths[syms]                                  # (s, per)
    codes = code.codes[syms].astype(np.uint32)

    # valid mask (ignore padding symbols)
    valid = np.arange(per)[None, :] < n_per[:, None]
    lens = np.where(valid, lens, 0)

    bit_lengths = lens.sum(axis=1).astype(np.int64)
    max_bits = int(bit_lengths.max()) if s else 0
    max_bytes = (max_bits + 7) // 8 + 4                        # decode slack
    out = np.zeros((s, max_bytes * 8), np.uint8)

    # vectorized bit placement per stream
    ends = np.cumsum(lens, axis=1)
    starts = ends - lens
    total = int(lens.sum())
    if total:
        row = np.repeat(np.arange(s)[:, None].repeat(per, 1).reshape(-1),
                        lens.reshape(-1))
        off = np.repeat(starts.reshape(-1), lens.reshape(-1))
        intra = (np.arange(total)
                 - np.repeat(np.cumsum(lens.reshape(-1))
                             - lens.reshape(-1), lens.reshape(-1)))
        l_rep = np.repeat(lens.reshape(-1), lens.reshape(-1))
        c_rep = np.repeat(codes.reshape(-1), lens.reshape(-1))
        bits = (c_rep >> (l_rep - 1 - intra)) & 1
        out[row, off + intra] = bits.astype(np.uint8)

    streams = np.packbits(out, axis=1)
    return EncodedChunk(streams=streams, bit_lengths=bit_lengths,
                        n_per_stream=n_per, n_symbols_alphabet=n_alphabet,
                        code=code, n_total=n)


def decode(enc: EncodedChunk) -> np.ndarray:
    sym_t, len_t = enc.code.decode_table()
    s, nbytes = enc.streams.shape
    per = int(enc.n_per_stream.max())
    out = np.zeros((s, per), np.uint16)
    pos = np.zeros(s, np.int64)
    b = enc.streams.astype(np.uint32)
    pad = np.zeros((s, 4), np.uint32)
    b = np.concatenate([b, pad], axis=1)
    rows = np.arange(s)
    active_count = enc.n_per_stream.copy()
    for i in range(per):
        byte_idx = pos >> 3
        shift = (pos & 7).astype(np.uint32)
        w = ((b[rows, byte_idx] << 16)
             | (b[rows, byte_idx + 1] << 8)
             | b[rows, byte_idx + 2])
        w = (w >> (8 - shift)) & 0xFFFF
        sym = sym_t[w]
        ln = len_t[w]
        act = i < active_count
        out[:, i] = np.where(act, sym, 0)
        pos = pos + np.where(act, ln.astype(np.int64), 0)
    flat = []
    for r in range(s):
        flat.append(out[r, :int(enc.n_per_stream[r])])
    return np.concatenate(flat) if flat else np.zeros(0, np.uint16)


def entropy_bits(symbols: np.ndarray, n_alphabet: int) -> float:
    counts = np.bincount(np.asarray(symbols, np.int64).reshape(-1),
                         minlength=n_alphabet).astype(np.float64)
    p = counts / max(counts.sum(), 1)
    nz = p[p > 0]
    return float(-(nz * np.log2(nz)).sum())
