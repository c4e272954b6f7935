"""Greedy serving's share of the bf16 peak: the recognizer's forward
FLOPs of each line served at its own width (so the buckets' padding counts
as waste), over the untraced window's wall time."""


def read(ctx):
    return 100.0 * ctx.forward_flops() / ctx.window_s / \
        ctx.roofline.BF16_OPS_PER_S
