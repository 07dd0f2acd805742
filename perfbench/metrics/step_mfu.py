"""step_mfu: the whole step's share of the card's bf16 peak in the traced
window: model FLOPs of its steps (``perfbench.flops.model_flops``) over
the window's host time at 989e12 FLOP/s. It bounds every kernel's
roofline share from above in what it can claim."""

from perfbench import flops


def read(t):
    if t.window_s <= 0 or not t.steps:
        return None
    f = flops.model_flops(t.info["model"], t.info["batch"], t.info["seq"])
    return 100.0 * f * t.steps / (t.window_s * flops.H100_PEAK_BF16)
