"""The kv_dequant launches' share of their byte bound in the traced
requests, in %: the bytes the launches need at the card's HBM rate, over
the device time of the ``dequant_kernel`` operations in the trace.

A launch's bytes: each code read once (1 byte), each value written once
(4 bytes: the cache it assembles is float32), each group's two float32
parameters and each entry's table row (5 int64) read once; an entry is
one streamed chunk's K or V, of chunk_tokens x kv heads x head_dim
values. Its operations (one multiply-add a value) take under a
hundredth of the time its bytes take, so the bytes bound it."""

KERNEL = "dequant_kernel"


def launch_bytes(n_entries: int, chunk_values: int, group: int,
                 out_bytes: int = 4) -> int:
    n = n_entries * chunk_values
    groups = n_entries * (-(-chunk_values // group))
    return n * (1 + out_bytes) + 8 * groups + 40 * n_entries


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.peak is None:
        return None
    secs = sum(s for name, s in tr["kernels"] if KERNEL in name)
    if secs <= 0:
        return None
    m, sp = ctx.model, ctx.sparkv
    values = sp["chunk_tokens"] * m["num_kv_heads"] * m["head_dim"]
    nbytes = sum(launch_bytes(2 * r.n_streamed, values, sp["quant_group"])
                 for r in ctx.traced if r.n_streamed)
    if not nbytes:
        return None
    return 100.0 * nbytes / ctx.peak["hbm_bytes_per_s"] / secs
