"""Device: the share of the profiled stretch in which no operation ran
on the card (one less the union of the device operations' intervals
over the stretch's length), in percent."""

from mdbench import yardstick


def read(ctx):
    if ctx.events is None or not ctx.on_device:
        return None
    lo, hi = ctx.stretch
    if not yardstick.device_ops(ctx.events):
        return None
    return 100.0 * (1.0 - yardstick.busy_us(ctx.events, lo, hi) / (hi - lo))
