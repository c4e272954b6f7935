"""Kernel launches in the card-only trace over the skip search's segment
steps in the traced window (K4's launch counter)."""


def read(ctx):
    steps = ctx.trace_counters.get("k4", 0)
    if ctx.kernels is None or not steps:
        return None
    return ctx.kernel_launches() / steps
