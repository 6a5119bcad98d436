"""Huffman-coded chunk tensors for the port's decode tests, on the CPU
(tests/test_torch_huffman_decode.py) and on the card
(tests/test_torch_cuda.py): the alphabets 2, 32 and 256 in 1, 7 and 64
streams at a symbol count that is a multiple of neither; zero-length last
streams; one symbol present; a one-symbol alphabet; a skewed distribution
whose codes reach MAX_LEN 16; and an empty tensor."""
import zlib

import numpy as np

HUFFMAN_CASES = [f"a{a}-s{s}" for a in (2, 32, 256) for s in (1, 7, 64)] \
    + ["zero-length-streams", "one-symbol-present", "one-symbol-alphabet",
       "max-len-16", "empty"]


def huffman_symbols(name):
    """(symbols, alphabet, streams) of the case `name`, seeded by it."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name.startswith("a"):
        alphabet, streams = (int(x) for x in name[1:].split("-s"))
        x = np.round(rng.normal(alphabet / 2, alphabet / 6, 3001))
        return np.clip(x, 0, alphabet - 1).astype(np.uint16), alphabet, \
            streams
    if name == "zero-length-streams":         # 900 in 64: 4 empty streams
        return rng.integers(0, 32, 900).astype(np.uint16), 32, 64
    if name == "one-symbol-present":
        return np.full(500, 5, np.uint16), 32, 64
    if name == "one-symbol-alphabet":
        return np.zeros(100, np.uint16), 1, 7
    if name == "max-len-16":                  # counts 2^15 .. 1, 1
        counts = [1 << k for k in range(15, -1, -1)] + [1]
        x = np.repeat(np.arange(len(counts), dtype=np.uint16), counts)
        return rng.permutation(x), 32, 64
    assert name == "empty"
    return np.zeros(0, np.uint16), 32, 64
