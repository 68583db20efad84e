"""
The port's tracing module (uf3_tpu_torch/util/tracing.py, on
torch.profiler) against ``uf3_tpu/util/tracing.py``'s interface: a CPU
trace writes its Chrome trace file and holds the annotated ranges among
its events; ``timer`` / ``report_timings`` give the reference's keys and
counts; the busy share, top operations and idle gaps read a trace's
device intervals (here a stand-in profile with known intervals, since
this host has no card; user annotations are left out of the device's
operations); a trace that asked for the card but holds no device
activity raises.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from uf3_tpu.util import tracing as j_tracing
from uf3_tpu_torch.util import tracing

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)


def test_cpu_trace_writes_its_file_and_annotations(tmp_path):
    tracing.report_timings(reset=True)
    with tracing.trace(str(tmp_path), device=False) as rec:
        with tracing.annotate("uf3 step"):
            x = torch.ones(64, 64, dtype=torch.float64)
            float((x @ x).sum())
    assert rec.path is not None and os.path.isfile(rec.path)
    assert str(tmp_path) in rec.path
    with open(rec.path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "uf3 step" for e in events)
    names = {e.name for e in rec.profile.events()}
    assert {"uf3 step", tracing.WINDOW} <= names
    assert ("uf3 step", False, True) in {row[:3] for row in rec.rows()}
    lo, hi = rec.window()
    assert hi > lo and rec.wall_s > 0
    assert tracing.report_timings()["trace"]["count"] == 1
    # no log_dir: nothing written
    with tracing.trace(device=False) as rec2:
        torch.zeros(3).sum()
    assert rec2.path is None and rec2.profile is not None


def test_timer_and_report_timings_match_reference():
    tracing.report_timings(reset=True)
    j_tracing.report_timings(reset=True)
    for module in (tracing, j_tracing):
        for _ in range(3):
            with module.timer("step"):
                np.ones(10).sum()
        with module.timer("io"):
            pass
    with tracing.timer("sync", sync=torch.ones(3)):
        pass
    with tracing.timer("sync", sync=lambda: torch.zeros(2)):
        pass
    ours = tracing.report_timings(reset=False)
    ref = j_tracing.report_timings()
    for name in ("step", "io"):
        assert ours[name].keys() == ref[name].keys() \
            == {"count", "total", "mean", "min"}
        assert ours[name]["count"] == ref[name]["count"]
    assert ours["sync"]["count"] == 2
    assert ours["step"]["min"] <= ours["step"]["mean"] \
        <= ours["step"]["total"]
    assert tracing.report_timings() and tracing.report_timings() == {}


class _RawEvent:
    """A stand-in for one of the profiler's raw (kineto) events."""

    def __init__(self, name, device, annotation, start_us, end_us):
        self._row = (name, device, annotation, start_us, end_us)

    def name(self):
        return self._row[0]

    def device_type(self):
        return DeviceType.CUDA if self._row[1] else DeviceType.CPU

    def is_user_annotation(self):
        return self._row[2]

    def start_ns(self):
        return 1e3 * self._row[3]

    def end_ns(self):
        return 1e3 * self._row[4]


def _stand_in(spans, window=(0.0, 1000.0)):
    """A finished trace of device operations at ``spans`` (start, end,
    name) in us inside ``window``, with the window's own annotation on
    both the host and the device, as torch.profiler records it."""
    events = [_RawEvent(tracing.WINDOW, False, True, *window),
              _RawEvent(tracing.WINDOW, True, True, *window)]
    events += [_RawEvent(n, True, False, s, e) for s, e, n in spans]
    events.append(_RawEvent("aten::add", False, False, 10.0, 20.0))
    rec = tracing.Trace(device=True)
    rec.profile = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    return rec


def test_busy_share_top_ops_and_gaps():
    rec = _stand_in([(100.0, 200.0, "trio"), (150.0, 250.0, "pair"),
                     (600.0, 700.0, "pair"), (990.0, 1010.0, "copy")])
    assert rec.busy_intervals() == [(100.0, 250.0), (600.0, 700.0),
                                    (990.0, 1000.0)]
    assert rec.busy_ms() == pytest.approx(0.26)
    assert rec.busy_share() == pytest.approx(0.26)
    assert rec.device_ms() == pytest.approx(0.32)
    top = rec.top_ops(2)
    assert [t["name"] for t in top] == ["pair", "trio"]
    assert top[0]["ms"] == pytest.approx(0.2) and top[0]["calls"] == 2
    gaps = rec.idle_gaps(3)
    assert [g["ms"] for g in gaps] == pytest.approx([0.35, 0.29, 0.1])
    assert [g["at_ms"] for g in gaps] == pytest.approx([0.25, 0.7, 0.0])


def test_a_device_trace_without_device_activity_raises():
    rec = _stand_in([])
    with pytest.raises(RuntimeError, match="no device activity"):
        rec.busy_share()
    with pytest.raises(RuntimeError, match="no device activity"):
        rec.top_ops()
    cpu_only = _stand_in([])
    cpu_only.device = False
    assert cpu_only.busy_ms() == 0.0 and cpu_only.idle_gaps(1)[0]["ms"] == 1
