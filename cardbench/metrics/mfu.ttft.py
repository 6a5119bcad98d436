"""Model operations of the steps up to each request's first token (the
prompt's and the first output's) over the sum of the times to first
token, as a share of the card's bf16 peak, in %."""


def read(ctx):
    if ctx.peak is None or not ctx.requests:
        return None
    s = ctx.workload["context_tokens"]
    ops = sum(ctx.step_flops(ctx.model, s + j + 1)
              for r in ctx.requests for j in range(r.n_prompt + 1))
    secs = sum(r.ttft_ms for r in ctx.requests) / 1e3
    return 100.0 * ops / secs / ctx.peak["bf16_flops_per_s"]
