"""Seconds from the process's start to the end of the warm-up request:
imports, CUDA init, weights, the contexts' registration and the warm-up
(whose plan trains the planner's latency predictor)."""


def read(ctx):
    return ctx.setup_s
