"""I1's share of its roofline: the least time of the s8 implicit-GEMM conv
at every one of the recognizer's conv sites of each forward
(``roofline.i1_bound`` at the site's shape), over the summed device time
of I1's conv kernels (``wgmma`` and ``mma.sync``)."""


def read(ctx):
    ms = ctx.kernel_ms("conv_wgmma_kernel") + ctx.kernel_ms("conv_s8_kernel")
    if not ms:
        return None
    r, c = ctx.roofline, ctx.config
    bound = sum(r.i1_bound(shape, cout, k)[0]
                for b, w in ctx.trace_forward_shapes
                for _, shape, cout, k in r.hctr_conv_sites(
                    b, w, c["channels"], c["blocks"], c["img_height"]))
    return 100.0 * bound / ms
