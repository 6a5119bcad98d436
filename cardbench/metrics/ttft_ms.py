"""Median time to first token over the window's requests: from the CUDA
event recorded at issue to the one recorded after the decode step whose
logits give the first output token."""
import statistics


def read(ctx):
    if not ctx.requests:
        return None
    return statistics.median(r.ttft_ms for r in ctx.requests)
