"""Median over the window's requests that streamed a chunk of the
server's ``phase_s["huffman_decode.entropy"]`` span (host clock, the
``huffman.decode`` calls of each streamed chunk, K and V) over the chunks
the request streamed: the host's Huffman decode of one chunk, in ms."""
import statistics

KEY = "huffman_decode.entropy"


def read(ctx):
    rs = [r for r in ctx.requests if r.n_streamed >= 1]
    if not rs or any(KEY not in r.phase for r in rs):
        return None
    return statistics.median(r.phase[KEY] * 1e3 / r.n_streamed for r in rs)
