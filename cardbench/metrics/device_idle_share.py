"""1 - (union of the device's kernels, copies and sets) / (the traced
window), from the profiler's trace, in %."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
