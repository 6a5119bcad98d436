"""The server's ``phase_s["decode"]`` over the whole window divided by
the ``decode_step`` calls it made, in ms."""


def read(ctx):
    steps = sum(r.steps for r in ctx.requests)
    if not steps:
        return None
    return sum(r.phase.get("decode", 0.0) for r in ctx.requests) \
        * 1e3 / steps
