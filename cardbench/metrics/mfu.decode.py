"""Model operations of the steps after each request's first token over
the sum of (return - first token), as a share of the card's bf16 peak,
in %."""


def read(ctx):
    if ctx.peak is None or not ctx.requests:
        return None
    s = ctx.workload["context_tokens"]
    ops = sum(ctx.step_flops(ctx.model, s + j + 1)
              for r in ctx.requests
              for j in range(r.n_prompt + 1, r.n_prompt + r.max_new))
    secs = sum(r.after_first_ms for r in ctx.requests) / 1e3
    if not ops or secs <= 0:
        return None
    return 100.0 * ops / secs / ctx.peak["bf16_flops_per_s"]
