"""Time per output token over the whole window: the sum over requests of
(return - first token) over the sum of the tokens after the first."""


def read(ctx):
    n = sum(r.max_new - 1 for r in ctx.requests)
    if n <= 0:
        return None
    return sum(r.after_first_ms for r in ctx.requests) / n
