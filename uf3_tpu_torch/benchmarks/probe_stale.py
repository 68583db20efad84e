"""
Which launches trip the staleness flag during Langevin MD at 300 K, and
how far the atoms drift within a launch.  Port of
``benchmarks/probe_stale.py``.

The engine (bcc W 17^3 = 9,826 atoms, ``model_2and3.json``, float32,
3-level r-RESPA 6/3/24, skins 0.5 / 1.2 A, 72 / 16 slots) runs 126
Langevin steps, then 20 launches of 24.  After each launch the script
records the launch's ``stale`` flag (two atoms' drifts summing past a
list's skin: ``neighbors.needs_rebuild``) and the largest single-atom
drift since each list's build (``max_drift3`` against the 3-body list,
``max_drift2`` against the 2-body list).  ``MDSystem.run`` raises on a
neighbor overflow, so a finished probe had none.

    python -m uf3_tpu_torch.benchmarks.probe_stale [--device cpu]

writes ``benchmarks_data/artifacts_torch/probe_stale.json``.
"""

import argparse
import json

import torch

from uf3_tpu_torch.benchmarks import common
from uf3_tpu_torch.forcefield.md import MDSystem

# benchmarks/probe_stale.py:40-47
ENGINE = dict(rebuild_every=24, skin=0.5, skin_2b=1.2, capacity_2b=72,
              capacity_3b=16, n_respa=6, respa_mid=3)
WARM_STEPS = 126
LAUNCHES = 20
LAUNCH_STEPS = 24
TEMPERATURE = 300.0
DT_FS = 2.0


def max_drift(positions, nbr) -> float:
    """The largest single-atom distance from the list's build
    positions, A."""
    delta = positions - nbr.reference_positions
    return float(torch.sqrt(torch.max(torch.sum(delta * delta, dim=-1))))


def run(reps=common.VALIDATION_REPS, warm_steps: int = WARM_STEPS,
        launches: int = LAUNCHES, device=None, dtype=torch.float32, model=common.MODEL,
        velocities=None, friction_ps: float = 2.0, commit: str = None,
        keep: dict = None) -> dict:
    """The probe: ``warm_steps`` Langevin steps from 300 K velocities
    (seed 0, or ``velocities``), then ``launches`` Langevin launches of
    ``LAUNCH_STEPS``; one row a launch.  ``keep``, where given, receives
    the system and its last state."""
    device = common.resolve_device(device)
    system = MDSystem(model, common.bcc_w(reps), dtype=dtype, device=device,
                      **ENGINE)
    state = system.init_state(velocities=velocities,
                              temperature=TEMPERATURE, seed=0)
    langevin = dict(dt_fs=DT_FS, thermostat="langevin",
                    temperature=TEMPERATURE, friction_ps=friction_ps)
    if warm_steps:
        state = system.run(state, n_steps=warm_steps, **langevin)
    rows = []
    for i in range(launches):
        state = system.run(state, n_steps=LAUNCH_STEPS, **langevin)
        row = {"stale": bool(state.stale),
               "max_drift3": max_drift(state.positions, state.nbr3),
               "max_drift2": max_drift(state.positions, state.nbr2)}
        rows.append(row)
        print(i, row, flush=True)
    if keep is not None:
        keep.update(system=system, state=state)
    return common.stamp({"per_launch": rows}, device, commit)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--reps", type=int, nargs=3,
                        default=common.VALIDATION_REPS,
                        help="bcc W supercell (default 17 17 17)")
    parser.add_argument("--out-dir", default=common.ARTIFACTS)
    parser.add_argument("--commit", default=None,
                        help="the artifact's commit (default: git's short "
                             "commit)")
    args = parser.parse_args(argv)
    result = run(tuple(args.reps), device=args.device, commit=args.commit)
    print(json.dumps(result))
    path = common.write_artifact(result, args.out_dir, "probe_stale.json")
    print(f"wrote {path}")
    return result


if __name__ == "__main__":
    main()
