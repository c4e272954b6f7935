"""K1's share of its roofline: the least time of the fused log-softmax +
top-K over every batch's logits (``roofline.k1_bound`` at each batch's
``(rows x frames, classes)``) over K1's summed device time."""


def read(ctx):
    ms = ctx.kernel_ms("topk_logsoftmax_kernel")
    if not ms:
        return None
    k = ctx.config["lm"]["search_depth"]
    bound = sum(ctx.roofline.k1_bound(b * w, ctx.config["num_classes"], k)[0]
                for b, w in ctx.trace_forward_shapes)
    return 100.0 * bound / ms
