"""Real lines a flush of the daemon over its batch size, in %, counted at
the benchmark's wrapper of the flush (partial flushes are padded)."""


def read(ctx):
    if not ctx.fills:
        return None
    return 100.0 * sum(ctx.fills) / len(ctx.fills) / ctx.batch_size
