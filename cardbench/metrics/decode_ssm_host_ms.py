"""The host time of a decode step's Mamba2 mixers, all layers: the
server's ``phase_s["decode.step.ssm"]`` spans (``models.granite_hybrid``:
each Mamba layer's ``ssm.ssm_block``, its projections, conv window,
recurrence step, gated norm and output projection; host clock) summed
over the window's requests, over their ``decode_step`` calls, in ms.
None where the program has no such span (a transformer's step)."""

KEY = "decode.step.ssm"


def read(ctx):
    steps = sum(r.steps for r in ctx.requests)
    if not steps or any(KEY not in r.phase for r in ctx.requests):
        return None
    return sum(r.phase[KEY] for r in ctx.requests) * 1e3 / steps
