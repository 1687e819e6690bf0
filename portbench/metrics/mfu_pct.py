"""``mfu_pct``: the whole step's share of the card's bf16 peak: the
model's FLOPs a step (the configuration's system counts them from its
shapes, recomputation not counted) x the steps of the traced window,
over the window's wall time and the peak."""

from portbench.harness import yardstick


def read(run):
    peak = yardstick.peak_bf16_flops(run.card)
    if peak is None or not run.steps:
        return None
    return 100.0 * run.step_flops * run.steps / run.window_s / peak
