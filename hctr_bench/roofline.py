"""Frozen yardstick arithmetic: the H100's published peaks, the least time
of a kernel's work (its roofline bound), and the model FLOPs of the `hctr`
recognizer and of the char LM, all from shapes alone.

Copied from the port's smoke run (``chip_smoke.py``: ``bound_ms``,
``k1_bound``, ``i1_ops``, ``i1_bound``, ``quantize_bound``) so that later
changes to the program cannot move the yardstick. The counts are of the
work the algorithm needs, whatever implements it: each input byte read
once, each output byte written once, each multiply-add two operations.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12          # f32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # dense bf16 tensor cores
INT8_OPS_PER_S = 1979e12       # dense int8 tensor cores
PEAKS = {"bf16": BF16_OPS_PER_S, "int8": INT8_OPS_PER_S,
         "f32": F32_OPS_PER_S}
PEAK_SOURCE = "NVIDIA H100 SXM data sheet (dense, 700 W)"

K1_OPS_PER_LOGIT = 8           # max, sub, exp, add, sub, compare, add, top-K compare


def bound_ms(bytes_moved: float, ops: float, ops_per_s: float):
    """``(ms, bound by)``: bytes over the HBM rate or operations over the
    peak rate of their type, whichever is longer."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k1_bound(rows: int, classes: int, k: int, elem_bytes: int = 4):
    """K1 (fused log-softmax + top-K + blank + count above prune) over
    ``rows`` logit rows of ``classes``: each logit read once, the K values
    and indices, the blank log-prob and the count written once;
    ``K1_OPS_PER_LOGIT`` f32 operations a logit."""
    return bound_ms(rows * classes * elem_bytes + rows * k * 8 + rows * 8,
                    rows * classes * K1_OPS_PER_LOGIT, F32_OPS_PER_S)


def i1_ops(shape, cout: int, k: int) -> float:
    B, cin, H, W = shape
    return 2.0 * B * H * W * cout * cin * k * k


def i1_bound(shape, cout: int, k: int, out_bytes: int = 2):
    """I1's conv: the s8 activation and s8 weights read once, the
    compute-dtype output written once; the int8 operations at the int8
    peak."""
    B, cin, H, W = shape
    moved = B * H * W * cin + cout * cin * k * k + B * H * W * cout * out_bytes
    return bound_ms(moved, i1_ops(shape, cout, k), INT8_OPS_PER_S)


def quantize_bound(shape, in_bytes: int = 2):
    """I1's quantize: the compute-dtype activation read once and one s8
    byte an element written; it does no product."""
    n = 1.0
    for s in shape:
        n *= s
    return bound_ms(n * (in_bytes + 1), 0.0, INT8_OPS_PER_S)


# ------------------------------------------------------------ hctr shapes
def hctr_conv_sites(batch: int, width: int, channels: int = 512,
                    blocks: Sequence[int] = (2, 4, 5, 1),
                    height: int = 128) -> List[Tuple[str, tuple, int, int]]:
    """Every conv of the recognizer's forward at ``(batch, width)``, in
    order: ``(name, (B, Cin, H, W), Cout, k)``. The trunk halves the
    height after the stem and each stage and keeps the width."""
    widths = [channels // 8, channels // 4, channels // 2, channels,
              channels]
    c0 = widths[0]
    sites = [("conv0_1", (batch, 1, height, width), c0, 3),
             ("conv0_2", (batch, c0, height, width), c0, 3)]
    h, cin = height // 2, c0
    for stage in range(4):
        planes = widths[stage + 1]
        for b in range(blocks[stage]):
            name = f"block{stage + 1}_{b}"
            sites.append((f"{name}.conv1", (batch, cin, h, width), planes, 3))
            sites.append((f"{name}.conv2", (batch, planes, h, width), planes,
                          3))
            if cin != planes:
                sites.append((f"{name}.down_conv", (batch, cin, h, width),
                              planes, 1))
            cin = planes
        sites.append((f"conv{stage + 1}", (batch, planes, h, width), planes,
                      3))
        h //= 2
    return sites


def hctr_forward_flops(width: int, channels: int = 512,
                       blocks: Sequence[int] = (2, 4, 5, 1),
                       classes: int = 7375, height: int = 128) -> float:
    """Matrix FLOPs of one line's forward at ``width`` columns: every conv,
    the squeeze-and-excitation products and the CTC head (two a
    multiply-add); elementwise work is not counted."""
    flops = sum(i1_ops(shape, cout, k) for _, shape, cout, k in
                hctr_conv_sites(1, width, channels, blocks, height))
    widths = [channels // 4, channels // 2, channels, channels]
    for stage in range(4):
        c = widths[stage]
        flops += blocks[stage] * 2 * (2.0 * c * (c // 16))   # SE fc1, fc2
    feat = (height // 32) * channels
    return flops + 2.0 * width * feat * classes


def hctr_train_flops(width: int, channels: int = 512,
                     blocks: Sequence[int] = (2, 4, 5, 1),
                     classes: int = 7375, height: int = 128) -> float:
    """Forward plus backward of one line: the backward takes each product
    twice (the input's gradient and the weight's), but the first conv's
    input needs no gradient."""
    fwd = hctr_forward_flops(width, channels, blocks, classes, height)
    _, shape, cout, k = hctr_conv_sites(1, width, channels, blocks,
                                        height)[0]
    return 3.0 * fwd - i1_ops(shape, cout, k)


def lm_token_flops(context: int, d_model: int = 512, n_layers: int = 6,
                   d_ff: int = 2048, vocab: int = 7377) -> float:
    """Matrix FLOPs of one token of the char LM at ``context`` positions
    already cached: the q, k, v and output projections, the two FF
    products, the scores and the weighted sum over the context, and the
    tied head over the vocabulary."""
    per_layer = (2.0 * 4 * d_model * d_model + 2.0 * 2 * d_model * d_ff
                 + 2.0 * 2 * context * d_model)
    return n_layers * per_layer + 2.0 * d_model * vocab
