"""Requests completed over the seconds the client waited on them: host
clock, from issue to return, summed over the window's requests. The
harness's bookkeeping between requests (its host copies of what the
check reads) is left out; the window closes when the request in flight
at its end returns."""


def read(ctx):
    if not ctx.requests or ctx.served_s <= 0:
        return None
    return len(ctx.requests) / ctx.served_s
