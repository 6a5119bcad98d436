"""Median over the window's requests of the server's
``phase_s["decode.readback"]`` span (host clock): the copy of a request's
tokens and logits to the host at the end of its decode loop, where the
host waits for the steps it queued, in ms."""
import statistics

KEY = "decode.readback"


def read(ctx):
    if not ctx.requests or any(KEY not in r.phase for r in ctx.requests):
        return None
    return statistics.median(r.phase[KEY] * 1e3 for r in ctx.requests)
