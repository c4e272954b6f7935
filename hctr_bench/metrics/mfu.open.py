"""The daemon's flushes' share of the int8 peak: the forward FLOPs of each
flush's real lines at their own widths, over the flushes' service time
(dispatch to texts), in the untraced window. At a fixed offered rate a share of the window would
not move."""


def read(ctx):
    busy = sum(ctx.service_s)
    if not busy:
        return None
    flops = sum(ctx.line_flops(w) for ws in ctx.flush_line_widths
                for w in ws)
    return 100.0 * flops / busy / ctx.roofline.INT8_OPS_PER_S
