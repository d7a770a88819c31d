"""The whole step's share of the card's bf16 peak: the model flops of
the window's completed passes over the window's length × 989 TFLOP/s.
Read for every ``mfu.<stage>``; the cell's driver counts the flops."""

from benchmark import flops


def read(ctx):
    fl = ctx.window.extra.get("model_flops")
    if not fl or ctx.window.elapsed <= 0:
        return None
    return 100.0 * fl / (ctx.window.elapsed * flops.PEAK_BF16_FLOPS)
