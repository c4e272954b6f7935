"""Host us a line in the engine's preprocessing (``ServingEngine.
preprocess_array``: bucket, pad), under the benchmark's span around each
call."""


def read(ctx):
    us = ctx.preprocess_us
    return sum(us) / len(us) if us else None
