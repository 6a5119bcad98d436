"""Median over the window's requests of the server's own
``phase_s["plan"]`` span (host clock, ending in a device synchronise),
in ms."""
import statistics


def read(ctx):
    if not ctx.requests:
        return None
    return statistics.median(r.phase.get("plan", 0.0) * 1e3
                             for r in ctx.requests)
