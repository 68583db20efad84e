"""Kernels (``csrc/trio.cu``): the frozen ``trio_bound`` of the full-lane
trio kernel on the run's last 3-body rows, times the kernel's calls,
over the device time of those calls in the profiled stretch, in percent.
A call's energy instance is read from its template arguments.  The
triangle-lane instance has no bound here and is not counted."""

import re

from mdbench import yardstick

KERNEL = re.compile(r"\btrio_kernel<\s*float\s*,\s*(\d+)\s*,\s*(true|false)\s*>")


def read(ctx):
    if ctx.events is None or not ctx.on_device:
        return None
    rows = trio_rows(ctx.run)
    if rows is None:
        return None
    calls = {}
    for name, (n, us) in yardstick.kernel_us(
            ctx.events, ("trio_kernel<",)).items():
        match = KERNEL.search(name)
        if match is None:
            continue
        energy = match.group(2) == "true"
        c, t = calls.get(energy, (0, 0.0))
        calls[energy] = (c + n, t + us)
    if not calls:
        return None
    tables = yardstick.TrioTables(ctx.model_file)
    d, valid = rows
    bound_ms = sum(n * yardstick.trio_bound(tables, d, valid, energy)["ms"]
                   for energy, (n, _) in calls.items())
    device_ms = sum(us for _, us in calls.values()) / 1e3
    return 100.0 * bound_ms / device_ms


def trio_rows(run):
    """The 3-body rows at the run's last positions: displacements
    (N, K, 3) and the slot mask, from the program's 3-body list."""
    if "3b" not in run.lists:
        return None
    idx, shift, mask = run.lists["3b"]
    x = run.positions
    d = x[idx] + shift.to(x.dtype) @ run.cell_matrix.to(x.dtype) \
        - x[:, None, :]
    return d, mask
