"""
The headline MD throughput on the card.  Port of the root ``bench.py``.

The bench path (``common.BENCH``): ``model_2and3.json`` on bcc W 17^3 =
9,826 atoms, float32 (float64 on the CPU), 3-level r-RESPA 12/6/36 with
the (2.5, 3.5) A switch, skins 0.5 / 1.2 A, 72 / 16 slots, Langevin at
300 K from seed 0.  144 warm-up steps and the overflow check, one warm
720-step launch (``launch_chunks=10, sync=False``), then ``windows``
timed windows of 720 steps run alike, the card synchronized before each
clock read.  The overflow flags are read after the windows (an overflow
raises), and ``stale`` is ORed over them.  ``value`` is the median
window's atom-steps/s, as the reference's; ``value_min`` and
``value_max`` are the slowest and the fastest window.  The reference
times 3 windows; here 5, since the host's rate swings within a process
(the bench path's median read 3.56e6-5.36e6 across three runs on the
card).

``run_windows`` is the loop itself; ``md_scaling`` and
``throughput_gate`` time through it.

    python -m uf3_tpu_torch.benchmarks.bench [--device cpu]
        [--reps 17 17 17]

prints one JSON line with the reference's keys (``metric``, ``value``,
``unit``, ``vs_baseline``, ``stale``), the slowest and fastest window,
and the card's name and power limit (``card``).
"""

import argparse
import json
import statistics
import time
from typing import List, NamedTuple

import torch

from uf3_tpu_torch.benchmarks import common
from uf3_tpu_torch.forcefield.md import MDSystem

# bench.py:42-116
BASELINE_ATOM_STEPS = 8.7e5  # the reference CPU cost, 2-body (BASELINE.md)
REPS = (17, 17, 17)
WARM_STEPS = 144
WINDOW_STEPS = 720
WINDOWS = 5
LAUNCH_CHUNKS = 10
TEMPERATURE = 300.0
DT_FS = 2.0
FRICTION_PS = 2.0


class Windows(NamedTuple):
    """What ``run_windows`` measured."""
    state: object                 # the state after the last window
    seconds: List[float]          # wall seconds of each timed window
    stale: bool                   # any timed window outran a skin
    warm_positions: torch.Tensor  # the positions after the warm-up


def langevin(n_steps: int, friction_ps: float = FRICTION_PS, **kw) -> dict:
    """``MDSystem.run``'s arguments for ``n_steps`` Langevin steps at
    300 K and 2 fs."""
    return dict(n_steps=n_steps, dt_fs=DT_FS, thermostat="langevin",
                temperature=TEMPERATURE, friction_ps=friction_ps, **kw)


def window(n_steps: int = WINDOW_STEPS,
           friction_ps: float = FRICTION_PS) -> dict:
    """A timed window's ``MDSystem.run`` arguments: launches of
    ``LAUNCH_CHUNKS`` rebuild cycles, overflow flags queued."""
    return langevin(n_steps, friction_ps, launch_chunks=LAUNCH_CHUNKS,
                    sync=False)


def run_windows(system: MDSystem, state, warm_steps: int = WARM_STEPS,
                window_steps: int = WINDOW_STEPS, windows: int = WINDOWS,
                friction_ps: float = FRICTION_PS) -> Windows:
    """The warm-up (``warm_steps``, then the overflow check: an overflow
    raises), one warm window, then ``windows`` timed windows of
    ``window_steps``, the card synchronized before each clock read."""
    state = system.run(state, **langevin(warm_steps, friction_ps))
    if system.overflowed(state):
        raise RuntimeError("neighbor overflow in the warm-up at "
                           f"{state.positions.shape[0]} atoms")
    warm_positions = state.positions.clone()
    kw = window(window_steps, friction_ps)
    state = system.run(state, **kw)
    common.sync(system.device)
    seconds, stale = [], False
    for _ in range(windows):
        t0 = time.perf_counter()
        state = system.run(state, **kw)
        common.sync(system.device)
        seconds.append(time.perf_counter() - t0)
        stale = stale or bool(state.stale)
    return Windows(state, seconds, stale, warm_positions)


def bench_system(reps, device: torch.device):
    """The bench path's engine on bcc W ``reps``, float32 on the card
    (float64 on the CPU), and its state at 300 K from seed 0."""
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    system = MDSystem(common.MODEL, common.bcc_w(reps), dtype=dtype,
                      device=device, **common.BENCH)
    return system, system.init_state(temperature=TEMPERATURE, seed=0)


def run(reps=REPS, warm_steps: int = WARM_STEPS,
        window_steps: int = WINDOW_STEPS, windows: int = WINDOWS,
        device=None, commit: str = None, keep: dict = None) -> dict:
    """The bench line at bcc W ``reps``.  ``keep``, where given,
    receives the system and the last state."""
    device = common.resolve_device(device)
    system, state = bench_system(reps, device)
    timed = run_windows(system, state, warm_steps, window_steps, windows)
    if system.overflowed(timed.state):
        raise RuntimeError("neighbor overflow during the timed windows")
    n = timed.state.positions.shape[0]
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    median = statistics.median(timed.seconds)
    per_window = [n * window_steps / s for s in timed.seconds]
    value = n * window_steps / median
    result = {"metric": f"atom-steps/s (2+3-body W MD, {n} atoms, "
                        f"{common.platform(device)}, {name})",
              "value": value, "unit": "atom-steps/s",
              "vs_baseline": value / BASELINE_ATOM_STEPS,
              "stale": timed.stale,
              "value_min": min(per_window), "value_max": max(per_window),
              "window_atom_steps_per_s": per_window,
              "n_atoms": n, "windows": windows, "window_steps": window_steps,
              "ms_per_step": 1e3 * median / window_steps,
              "overflow": False, "platform": common.platform(device),
              "dtype": str(system.dtype).replace("torch.", "")}
    if keep is not None:
        keep.update(system=system, state=timed.state)
    return common.stamp(result, device, commit)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--reps", type=int, nargs=3, default=REPS,
                        help="bcc W supercell (default 17 17 17)")
    args = parser.parse_args(argv)
    result = run(tuple(args.reps), device=args.device)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
