"""Wall ms a segment step of the skip search: the untraced window's wall
time over the segment steps it ran, counted by K4's launch counter (the
cache commit launches once a segment step)."""


def read(ctx):
    steps = ctx.counters.get("k4", 0)
    return ctx.window_s * 1e3 / steps if steps else None
