"""
Profiling hooks on ``torch.profiler``: a device trace of a block of
code (``trace``) that reads back the device's busy share, its busiest
operations and its idle gaps; named wall-clock timers (``timer``,
``report_timings``); and annotations that show in the trace
(``annotate``).

Counterpart of ``uf3_tpu/util/tracing.py`` (``jax.profiler``).  Where
the reference carries on without a trace when the profiler fails to
start, ``trace`` raises, and a trace that asked for the card but holds
no device activity raises when it is read: a missing device trace never
passes for a measured one.
"""

import contextlib
import itertools
import os
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

_timings: Dict[str, list] = defaultdict(list)
_count = itertools.count()
WINDOW = "uf3_tpu_torch.trace"   # the record_function around a trace


class Trace:
    """What one ``trace`` recorded: ``profile`` (the finished
    ``torch.profiler.profile``, for ``key_averages()`` and ``events()``),
    ``path`` (its Chrome trace, or None), ``wall_s`` (host seconds inside
    the block, device synchronized at both ends) and ``device`` (whether
    device activity was asked for).  The readers below take the
    profiler's raw events once (a window of MD holds ~10^5 of them, which
    ``events()`` takes tens of seconds to build into a tree); user
    annotations (``annotate``, the window itself) are ranges, not device
    work, and are left out of the device's operations."""

    def __init__(self, device: bool):
        self.device = device
        self.profile = None
        self.path = None
        self.wall_s = None
        self._rows = None

    def rows(self) -> List[tuple]:
        """(name, on the device, user annotation, start us, end us) of
        every recorded event, on the profiler's clock."""
        if self._rows is None:
            from torch.autograd import DeviceType
            self._rows = [
                (e.name(), e.device_type() == DeviceType.CUDA,
                 e.is_user_annotation(), e.start_ns() / 1e3,
                 e.end_ns() / 1e3)
                for e in self.profile.profiler.kineto_results.events()]
        return self._rows

    def _device_ops(self) -> List[tuple]:
        ops = [(name, start, end)
               for name, on_device, annotation, start, end in self.rows()
               if on_device and not annotation]
        if self.device and not ops:
            raise RuntimeError("the trace holds no device activity: the "
                               "profiler did not trace the card")
        return ops

    def window(self):
        """(start, end) of the traced block on the profiler's clock, us."""
        for name, on_device, _, start, end in self.rows():
            if name == WINDOW and not on_device:
                return start, end
        raise RuntimeError("the trace lost its window event")

    def busy_intervals(self) -> List[tuple]:
        """The union of the device's operation intervals inside the
        window, (start, end) in us, in order."""
        lo, hi = self.window()
        spans = sorted((max(start, lo), min(end, hi))
                       for _, start, end in self._device_ops())
        union = []
        for start, end in spans:
            if end <= start:
                continue
            if union and start <= union[-1][1]:
                union[-1] = (union[-1][0], max(union[-1][1], end))
            else:
                union.append((start, end))
        return union

    def busy_ms(self) -> float:
        """Device busy time: the union of its intervals, ms."""
        return sum(end - start for start, end in self.busy_intervals()) / 1e3

    def busy_share(self) -> float:
        """Busy time over the window's length on the same clock."""
        lo, hi = self.window()
        return 1e3 * self.busy_ms() / (hi - lo)

    def device_ms(self) -> float:
        """The device operations' own times summed (overlaps counted
        twice), ms."""
        return sum(end - start for _, start, end in self._device_ops()) / 1e3

    def top_ops(self, n: int = 5) -> List[dict]:
        """The ``n`` device operations that took the most time: name,
        total ms, calls."""
        totals = defaultdict(lambda: [0.0, 0])
        for name, start, end in self._device_ops():
            totals[name][0] += end - start
            totals[name][1] += 1
        top = sorted(totals.items(), key=lambda item: -item[1][0])[:n]
        return [dict(name=name, ms=us / 1e3, calls=calls)
                for name, (us, calls) in top]

    def idle_gaps(self, n: int = 5) -> List[dict]:
        """The ``n`` longest stretches of the window with no device
        operation: where each starts (ms into the window) and its length
        (ms)."""
        lo, hi = self.window()
        edges = [lo] + [x for span in self.busy_intervals() for x in span] \
            + [hi]
        gaps = [(edges[i + 1] - edges[i], edges[i] - lo)
                for i in range(0, len(edges), 2)]
        gaps.sort(reverse=True)
        return [dict(at_ms=at / 1e3, ms=length / 1e3)
                for length, at in gaps[:n] if length > 0]


@contextlib.contextmanager
def trace(log_dir: str = None, device: bool = None):
    """Trace the block with ``torch.profiler``: CPU activity and, on a
    card (``device`` defaults to whether one is available), CUDA
    activity, the card synchronized as the block starts and ends.
    Yields a ``Trace``, filled in when the block ends; with ``log_dir``
    the Chrome trace is written there.  Raises where the profiler cannot
    start."""
    from torch.profiler import ProfilerActivity, profile, record_function
    if device is None:
        device = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device else [])
    rec = Trace(device)
    if device:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            yield rec
            if device:
                torch.cuda.synchronize()
        rec.wall_s = time.perf_counter() - t0
    rec.profile = prof
    _timings["trace"].append(rec.wall_s)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        rec.path = os.path.join(
            log_dir, f"trace_{os.getpid()}_{next(_count)}.json")
        prof.export_chrome_trace(rec.path)


@contextlib.contextmanager
def timer(name: str, sync=None):
    """Accumulate wall-clock time under ``name``.  ``sync``, a tensor or
    a callable returning one, has its device synchronized before the
    clock stops."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            tensor = sync() if callable(sync) else sync
            if tensor.device.type == "cuda":
                torch.cuda.synchronize(tensor.device)
        _timings[name].append(time.perf_counter() - t0)


def report_timings(reset: bool = True) -> Dict[str, Dict[str, float]]:
    """Count, total, mean and min seconds of each name's timings."""
    summary = {}
    for name, values in _timings.items():
        arr = np.asarray(values)
        summary[name] = dict(count=len(arr), total=float(arr.sum()),
                             mean=float(arr.mean()), min=float(arr.min()))
    if reset:
        _timings.clear()
    return summary


@contextlib.contextmanager
def annotate(name: str):
    """A named range in the trace: a ``record_function`` and, on a card,
    an NVTX range."""
    from torch.profiler import record_function
    with contextlib.ExitStack() as stack:
        stack.enter_context(record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield
