"""
MD throughput against system size on the card.  Port of
``benchmarks/md_scaling.py``.

The bench model (``model_2and3.json``) on bcc W reps^3 for reps 17, 25
and 34 (9,826, 31,250 and 78,608 atoms), through the bench engine
(``common.BENCH``: 3-level r-RESPA 12/6/36, switch (2.5, 3.5) A, skins
0.5 / 1.2 A, 72 / 16 slots, full trio lanes, eager refilter), float32,
Langevin at 300 K.  The reference's docstring says "9/3, rebuild_every
27, triangle trio kernel"; its code runs 12/6/36 on full lanes, and the
port follows the code.

Per size: 144 Langevin warm-up steps, one warm 720-step launch
(``launch_chunks=10, sync=False``), then 3 windows of 720 steps run
alike, the card synchronized before each clock read (``bench.run_windows``,
the loop the headline bench times).  The rate is the
median window's atom-steps/s, as the reference's; beside it the least
and the greatest window, ``overflow`` and ``stale`` after the windows,
and the card's busy share over one more window traced by
``util/tracing.py`` (the union of the device's operations over the
window; a traced window runs slower than one untraced).  The traced
windows run after every size's timed ones, so that no profiler trace
comes before a timed window.  The artifact is written after each size,
as the reference writes it, and again with the busy shares.

    python -m uf3_tpu_torch.benchmarks.md_scaling [reps ...]
        [--device cpu]

(default 17 25 34) writes ``benchmarks_data/artifacts_torch/md_scaling.json``.
On the CPU (float64) ``busy_share`` is null.
"""

import argparse
import json
import os
import statistics

import torch

from uf3_tpu_torch.benchmarks import bench, common
from uf3_tpu_torch.benchmarks.bench import (TEMPERATURE, WARM_STEPS,
                                            WINDOW_STEPS)
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.util import tracing

# benchmarks/md_scaling.py:40-77
REPS = (17, 25, 34)
WINDOWS = 3
CONFIG = ("bench engine (respa 12/6/36, switch (2.5, 3.5), skins 0.5 / 1.2 "
          "A, 72 / 16 slots, full trio lanes, eager refilter, launch_chunks "
          "10)")


def run(reps_list=REPS, warm_steps: int = WARM_STEPS,
        window_steps: int = WINDOW_STEPS, windows: int = WINDOWS,
        device=None, model=common.MODEL, velocities=None,
        friction_ps: float = 2.0, commit: str = None, out_path: str = None,
        keep: dict = None) -> dict:
    """The rate at each bcc W reps^3 of ``reps_list``, from 300 K
    velocities (seed 0, or ``velocities`` for a single size) under
    Langevin at ``friction_ps``.  With ``out_path`` the artifact is
    written there after each size.  ``keep``, where given, receives per
    size the system, the positions after the warm-up and the last
    state."""
    device = common.resolve_device(device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    on_card = device.type == "cuda"
    result = common.stamp({"platform": common.platform(device),
                           "config": CONFIG,
                           "dtype": str(dtype).replace("torch.", ""),
                           "sizes": []}, device, commit)
    window = bench.window(window_steps, friction_ps)
    kept = []
    for reps in reps_list:
        geom = common.bcc_w((reps, reps, reps))
        n = len(geom)
        system = MDSystem(model, geom, dtype=dtype, device=device,
                          **common.BENCH)
        state = system.init_state(velocities=velocities,
                                  temperature=TEMPERATURE, seed=0)
        timed = bench.run_windows(system, state, warm_steps, window_steps,
                                  windows, friction_ps)
        state, seconds = timed.state, timed.seconds
        median = statistics.median(seconds)
        row = {"n_atoms": n,
               "atom_steps_per_s": n * window_steps / median,
               "ms_per_step": 1e3 * median / window_steps,
               "overflow": bool(system.overflowed(state)),
               "stale": bool(state.stale),
               "atom_steps_per_s_min": n * window_steps / max(seconds),
               "atom_steps_per_s_max": n * window_steps / min(seconds),
               "window_atom_steps_per_s": [n * window_steps / s
                                           for s in seconds],
               "busy_share": None, "traced_atom_steps_per_s": None}
        result["sizes"].append(row)
        print(json.dumps(row), flush=True)
        write(result, out_path)
        kept.append(dict(system=system, warm_positions=timed.warm_positions,
                         state=state))
    if on_card:
        for row, size in zip(result["sizes"], kept):
            with tracing.trace() as rec:
                size["state"] = size["system"].run(size["state"], **window)
            row.update(busy_share=rec.busy_share(),
                       traced_atom_steps_per_s=row["n_atoms"]
                       * window_steps / rec.wall_s)
            print(f"{row['n_atoms']} atoms: busy share "
                  f"{row['busy_share']:.4f}", flush=True)
        write(result, out_path)
    if keep is not None:
        keep["sizes"] = kept
    return result


def write(result: dict, out_path: str = None):
    """The artifact at ``out_path``, where one is given."""
    if out_path is not None:
        common.write_artifact(result, os.path.dirname(out_path) or ".",
                              os.path.basename(out_path))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("reps", type=int, nargs="*",
                        help="bcc W reps^3 per size (default 17 25 34)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--out-dir", default=common.ARTIFACTS)
    parser.add_argument("--commit", default=None,
                        help="the artifact's commit (default: git's short "
                             "commit)")
    args = parser.parse_args(argv)
    path = os.path.join(args.out_dir, "md_scaling.json")
    result = run(tuple(args.reps) or REPS, device=args.device,
                 commit=args.commit, out_path=path)
    print(json.dumps(result))
    print(f"wrote {path}")
    return result


if __name__ == "__main__":
    main()
