"""The stream cell's request rate, read per layer: requests completed over
the seconds the client waited on them, as ``requests_per_s`` reads it
(host clock, issue to return, summed over the window's requests outside
the traced part). In that cell the host's speed moves it by more than any
bound allows, so there it stands beside ``ttft_ms`` with none."""


def read(ctx):
    if not ctx.requests or ctx.served_s <= 0:
        return None
    return len(ctx.requests) / ctx.served_s
