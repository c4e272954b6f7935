"""The device's idle share of the traced window: 1 - (the union of the
device operations' intervals) / (the window's wall time), in %."""


def read(ctx):
    return ctx.idle_pct()
