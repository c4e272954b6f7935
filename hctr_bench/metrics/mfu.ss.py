"""The LM route's share of the bf16 peak over the window: the recognizer's
forward of each line served at its own width, plus the char LM's work the
search needs (each of the beam's hypotheses extended once a character of
the line's label, at the label's mean context), over the untraced window's
wall time."""


def read(ctx):
    lm, r = ctx.config["lm"], ctx.roofline
    cfg = lm["config"]
    flops = ctx.forward_flops()
    for chars in ctx.line_chars:
        flops += lm["beam_size"] * chars * r.lm_token_flops(
            chars / 2, cfg["d_model"], cfg["n_layers"], cfg["d_ff"],
            cfg["vocab_size"])
    return 100.0 * flops / ctx.window_s / r.BF16_OPS_PER_S
