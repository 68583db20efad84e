"""Whole step: the useful flop of one force evaluation (228 a real
triangle, 40 a real pair, counted by the reference's neighbour search at
the run's last positions) over the untraced window's time a step at the
card's float32 peak (67 TFLOP/s), in percent."""

from mdbench import yardstick


def read(ctx):
    if not ctx.on_device or not ctx.run.window_steps:
        return None
    per_s = ctx.useful_flop / (ctx.ms_per_step / 1e3)
    return 100.0 * per_s / yardstick.PEAK_FLOPS_F32
