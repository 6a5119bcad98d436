"""The host's dispatch of one decode step: the server's
``phase_s["decode.step"]`` spans (each ``model.decode_step`` call, host
clock) summed over the window's requests, over their ``decode_step``
calls, in ms."""

KEY = "decode.step"


def read(ctx):
    steps = sum(r.steps for r in ctx.requests)
    if not steps or any(KEY not in r.phase for r in ctx.requests):
        return None
    return sum(r.phase[KEY] for r in ctx.requests) * 1e3 / steps
