"""
The benchmark's frozen arithmetic: the card's peaks, the reading of a
profiler trace (device busy time as a union of intervals, the busiest
operations, the idle gaps named by what the host was doing, the host's
launch calls), the useful flop of an MD step and the least time of one
trio kernel call.  Later changes to the program cannot move this
yardstick: nothing here imports the program.

Sources, copied and frozen:

- the busy-share arithmetic of ``uf3_tpu_torch/util/tracing.py``
  (``Trace.busy_intervals``, ``top_ops``, ``idle_gaps``);
- ``useful_flops_per_step`` of ``uf3_tpu_torch/benchmarks/
  budget_step.py`` (228 flop a real triangle, 40 a real pair), here on
  counted neighbours rather than on fixed coordinations;
- ``trio_bound`` of ``uf3_tpu_torch/ops/trio.py`` (the full-lane
  instance), with the potential's tables worked out again from the
  model file, on blocks of rows.
"""

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
PEAK_FLOPS_F32 = 67e12
PEAK_BYTES = 3.35e12

# host-side CUDA calls that put work on a stream
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                "cudaMemcpyAsync", "cudaMemsetAsync")

WINDOW = "mdbench.stretch"   # the record_function around a stretch


# -- trace ----------------------------------------------------------------
class Event:
    """One profiler event: name, on the device, a user annotation, start
    and end in us on the profiler's clock."""
    __slots__ = ("name", "device", "annotation", "start", "end")

    def __init__(self, name, device, annotation, start, end):
        self.name, self.device, self.annotation = name, device, annotation
        self.start, self.end = start, end


def events_of(prof) -> List[Event]:
    """The finished ``torch.profiler.profile``'s raw kineto events (the
    tree that ``events()`` builds takes tens of seconds on an MD
    stretch)."""
    from torch.autograd import DeviceType
    return [Event(e.name(), e.device_type() == DeviceType.CUDA,
                  e.is_user_annotation(), e.start_ns() / 1e3,
                  e.end_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()]


def window_of(events: Sequence[Event]) -> Tuple[float, float]:
    """(start, end) of the stretch's own range on the host, us."""
    for e in events:
        if e.name == WINDOW and not e.device:
            return e.start, e.end
    raise RuntimeError("the trace lost the stretch's range")


def device_ops(events: Sequence[Event]) -> List[Event]:
    """The device's operations: kernels, copies, sets (annotations
    are ranges, not work)."""
    return [e for e in events if e.device and not e.annotation]


def busy_intervals(events: Sequence[Event], lo: float,
                   hi: float) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals inside [lo, hi],
    in order."""
    spans = sorted((max(e.start, lo), min(e.end, hi))
                   for e in device_ops(events))
    union = []
    for start, end in spans:
        if end <= start:
            continue
        if union and start <= union[-1][1]:
            union[-1] = (union[-1][0], max(union[-1][1], end))
        else:
            union.append((start, end))
    return union


def busy_us(events: Sequence[Event], lo: float, hi: float) -> float:
    return sum(end - start for start, end in busy_intervals(events, lo, hi))


def top_ops(events: Sequence[Event], n: int = 10) -> List[list]:
    """[name, seconds] of the ``n`` device operations that took the most
    time in all, their own times summed."""
    totals = defaultdict(float)
    for e in device_ops(events):
        totals[e.name] += e.end - e.start
    top = sorted(totals.items(), key=lambda item: -item[1])[:n]
    return [[name, us / 1e6] for name, us in top]


def idle_gaps(events: Sequence[Event], lo: float, hi: float,
              n: int = 10) -> List[list]:
    """[what the host was doing, seconds]: the stretches of [lo, hi]
    with no device operation, each named by the innermost host event
    (the latest to start) that covers its middle, summed by name; the
    ``n`` largest."""
    edges = [lo] + [x for span in busy_intervals(events, lo, hi)
                    for x in span] + [hi]
    host = sorted(((e.start, e.end, e.name) for e in events
                   if not e.device and not e.annotation
                   and e.name != WINDOW), key=lambda t: t[0])
    starts = np.array([h[0] for h in host])
    totals = defaultdict(float)
    for k in range(0, len(edges), 2):
        a, b = edges[k], edges[k + 1]
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = "no host event"
        # the innermost event that covers the middle: scan back from the
        # last one to start before it
        j = int(np.searchsorted(starts, mid, side="right")) - 1
        for jj in range(j, max(-1, j - 4096), -1):
            if host[jj][1] >= mid:
                name = host[jj][2]
                break
        totals[name] += b - a
    top = sorted(totals.items(), key=lambda item: -item[1])[:n]
    return [[name, us / 1e6] for name, us in top]


def launch_calls(events: Sequence[Event], lo: float, hi: float) -> int:
    """Host-side runtime calls that put work on a stream, inside
    [lo, hi]."""
    return sum(1 for e in events
               if not e.device and lo <= e.start <= hi
               and e.name.startswith(LAUNCH_CALLS))


def kernel_us(events: Sequence[Event], needles: Sequence[str]) -> Dict[
        str, Tuple[int, float]]:
    """name -> (calls, summed device us) of the device operations whose
    names contain one of ``needles``."""
    out = defaultdict(lambda: [0, 0.0])
    for e in device_ops(events):
        if any(s in e.name for s in needles):
            out[e.name][0] += 1
            out[e.name][1] += e.end - e.start
    return {k: (v[0], v[1]) for k, v in out.items()}


# -- useful work ----------------------------------------------------------
FLOP_TRIANGLE = 2 * (30 + 64 + 20)   # 3 legs' 4-tap values and slopes,
#   the 4 x 4 x 4 contraction, the force's product rule (FMA = 2)
FLOP_PAIR = 2 * 20                   # 4-tap value and slope, the force


def useful_flops(n3: torch.Tensor, n2: torch.Tensor) -> float:
    """The physics count of one force evaluation: 228 flop for each real
    triangle (a centre and an unordered pair of its neighbours inside
    the 3-body legs' cutoff) and 40 for each real ordered pair inside
    the 2-body cutoff; ``n3`` and ``n2`` are the counts of neighbours a
    centre has inside each cutoff."""
    n3 = n3.double()
    triangles = float(torch.sum(n3 * (n3 - 1) / 2))
    return FLOP_TRIANGLE * triangles + FLOP_PAIR * float(torch.sum(
        n2.double()))


# -- the trio kernel's least time -----------------------------------------
class TrioTables:
    """What ``trio_bound`` reads of a unary 2+3-body model: the legs'
    uniform knots (t_min, h, n_int), the grid's live window, and the
    sizes of the kernel's table operands."""

    def __init__(self, model: dict):
        key = [k for k, v in model["knots"].items()
               if isinstance(v[0], list)]
        if len(key) != 1:
            raise ValueError("trio_bound reads a unary 2+3-body model")
        knots = model["knots"][key[0]]
        grid = np.asarray(model["coefficients"][key[0]], dtype=np.float64)
        grid = 0.5 * (grid + grid.transpose(1, 0, 2))

        def leg(seq):
            pts = np.unique(np.asarray(seq, dtype=np.float64))
            n_int = len(pts) - 1
            return float(pts[0]), float(pts[-1]), n_int
        self.leg_l = leg(knots[0])
        self.leg_n = leg(knots[2])
        alive = ~np.all(grid == 0.0, axis=0)               # (M, NC)
        l_alive = np.nonzero(~np.all(grid == 0.0, axis=(1, 2)))[0]
        bs = [b for b in range(grid.shape[1]) if alive[b].any()]
        cs = [c for b in bs for c in np.nonzero(alive[b])[0]]
        self.window = (int(min(l_alive.min(), min(bs))),
                       int(max(l_alive.max(), max(bs))) + 1,
                       int(min(cs)), int(max(cs)) + 1)
        w_lo, w_hi, c_lo, c_hi = self.window
        self.grid_window_numel = (w_hi - w_lo) ** 2 * (c_hi - c_lo)
        self.leg_tables_numel = (self.leg_l[2] + self.leg_n[2]) * 20


def _interval(r, leg):
    t_min, t_max, n_int = leg
    h = (t_max - t_min) / n_int
    return torch.clamp(torch.floor((r - t_min) / h).to(torch.int64), 0,
                       n_int - 1)


def trio_bound(tables: TrioTables, d, valid, with_energy: bool,
               elem_size: int = 4, block: int = 8192) -> dict:
    """The least time one full-lane trio kernel call needs on these rows
    (``d`` (N, K, 3) displacements, ``valid`` (N, K)): the flop its
    algorithm does for this data (an FMA is 2) over the float32 peak,
    against each input read once and each output written once over the
    memory rate.  Returns ms, flop, bytes and which bound binds."""
    w_lo, w_hi, c_lo, c_hi = tables.window
    ww, cw = w_hi - w_lo, c_hi - c_lo
    t_min_n, t_max_n, _ = tables.leg_n
    n_atoms, k = d.shape[:2]
    taps = torch.arange(4, device=d.device)
    eye = torch.eye(k, dtype=torch.bool, device=d.device)
    term = 6 if with_energy else 4    # 2 or 3 FMAs per (b, c) term
    energy = int(with_energy)
    lane_flop = 0.0
    row_flop = 0.0
    n_rows = 0
    for lo in range(0, n_atoms, block):
        db = d[lo:lo + block].double()
        ok = valid[lo:lo + block] != 0
        r = torch.sqrt(torch.sum(db * db, -1).clamp_min(1e-300))
        idx = _interval(r, tables.leg_l)
        b_live = (((idx[..., None] + taps) >= w_lo)
                  & ((idx[..., None] + taps) < w_hi)).sum(-1)
        diff = db[:, None, :, :] - db[:, :, None, :]
        r_mn2 = torch.sum(diff * diff, -1)
        r_mn = torch.sqrt(r_mn2.clamp_min(1e-300))
        lane = (ok[:, :, None] & ok[:, None, :] & ~eye & (r_mn2 > 1e-10)
                & (r_mn >= t_min_n) & (r_mn <= t_max_n))
        cidx = _interval(r_mn, tables.leg_n)
        c_live = (((cidx[..., None] + taps) >= c_lo)
                  & ((cidx[..., None] + taps) < c_hi)).sum(-1)
        b_lane = b_live[:, None, :].expand_as(cidx)
        per_lane = (55 + 9 + energy + term * b_lane * c_live
                    + term * b_lane)
        lane_flop += float(torch.sum(per_lane * lane))
        row_flop += 4.0 * ww * cw * float(torch.sum(b_live * ok))
        n_rows += int(ok.sum())
    flop = lane_flop + n_rows * (52 + 4) + row_flop
    n_bytes = elem_size * (n_atoms * k * 4 + tables.grid_window_numel
                           + tables.leg_tables_numel + n_atoms * (4 + 5 * k))
    t_flop, t_bytes = flop / PEAK_FLOPS_F32, n_bytes / PEAK_BYTES
    return dict(ms=1e3 * max(t_flop, t_bytes), flop=flop, bytes=n_bytes,
                bound_by="operations" if t_flop >= t_bytes else "bytes")

