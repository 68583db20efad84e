"""Host loop: the host's CUDA runtime calls that put work on a stream
(kernel, graph, async copy and set launches) in the profiled stretch,
per MD step of the stretch."""

from mdbench import yardstick


def read(ctx):
    if ctx.events is None or not ctx.on_device or not ctx.run.trace_steps:
        return None
    lo, hi = ctx.stretch
    return yardstick.launch_calls(ctx.events, lo, hi) / ctx.run.trace_steps
