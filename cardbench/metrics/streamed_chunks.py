"""Median over the window's requests of the KV chunks the plan streamed
(the server's ``ServeResult.n_streamed``)."""
import statistics


def read(ctx):
    if not ctx.requests:
        return None
    return statistics.median(r.n_streamed for r in ctx.requests)
