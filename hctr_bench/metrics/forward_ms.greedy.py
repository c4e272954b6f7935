"""Device ms a batch of the recognizer's forward: CUDA events recorded on
the stream before and after each call of the engine's model."""


def read(ctx):
    ms = ctx.forward_ms
    return sum(ms) / len(ms) if ms else None
