"""
Long-horizon NVE check of an r-RESPA configuration: 5,184 steps (10.4
ps) of NVE after a 300 K Langevin equilibration, the total energy read
every 432 steps.  Port of ``benchmarks/validate_final.py``.  Deep
r-RESPA cadences can hide a slow resonance heating that a 720-step drift
check misses (the mid time step nears the phonons' stability edge).

The engine: bcc W 17^3 = 9,826 atoms, ``model_2and3.json``, float32,
skins 0.5 / 1.2 A, 72 / 16 slots, r-RESPA ``n_respa`` / ``respa_mid`` /
``rebuild``, the switch band (``r_lo``, 3.5) A where ``r_lo`` is given.
The run: 4 x rebuild Langevin steps at 300 K, then 12 NVE blocks of 12 x
rebuild steps in launches of 4 rebuild cycles, the drift (E - E0) / N
after each block.  A least-squares line through the trace separates
secular heating (its slope x 12, which disqualifies) from the bounded
shadow-energy offset (the trace's largest magnitude).  Both pass at 2e-4
eV/atom.  ``MDSystem.run`` raises on a neighbor overflow.

    python -m uf3_tpu_torch.benchmarks.validate_final [n_respa respa_mid
        rebuild [r_lo]] [--device cpu]

(defaults 18 6 36, no switch) writes
``benchmarks_data/artifacts_torch/validate_final_<n_respa>_<respa_mid>_<rebuild>[_lo<r_lo x 10>].json``.
"""

import argparse
import json

import numpy as np
import torch

from uf3_tpu_torch.benchmarks import common
from uf3_tpu_torch.forcefield.md import MDSystem

# benchmarks/validate_final.py:47-52
ENGINE = dict(skin=0.5, skin_2b=1.2, capacity_2b=72, capacity_3b=16)
R_HI = 3.5
BLOCKS = 12
LAUNCH_CHUNKS = 4
CRITERION = 2e-4   # eV/atom
TEMPERATURE = 300.0
DT_FS = 2.0


def run(n_respa: int = 18, respa_mid: int = 6, rebuild: int = 36,
        r_lo: float = None, reps=common.VALIDATION_REPS,
        warm_steps: int = None, blocks: int = BLOCKS,
        block_steps: int = None, device=None,
        dtype=torch.float32, model=common.MODEL, velocities=None,
        commit: str = None, keep: dict = None) -> dict:
    """The check: ``warm_steps`` (4 x rebuild) Langevin steps from 300 K
    velocities (seed 0, or ``velocities``), then ``blocks`` NVE blocks
    of ``block_steps`` (12 x rebuild).  ``keep``, where given, receives
    the system and its last state."""
    device = common.resolve_device(device)
    warm_steps = 4 * rebuild if warm_steps is None else warm_steps
    block_steps = block_steps or 12 * rebuild
    geom = common.bcc_w(reps)
    system = MDSystem(model, geom, dtype=dtype, device=device,
                      rebuild_every=rebuild, n_respa=n_respa,
                      respa_mid=respa_mid,
                      respa_switch=None if r_lo is None else (r_lo, R_HI),
                      **ENGINE)
    state = system.init_state(velocities=velocities,
                              temperature=TEMPERATURE, seed=0)
    if warm_steps:
        state = system.run(state, n_steps=warm_steps, dt_fs=DT_FS,
                           thermostat="langevin", temperature=TEMPERATURE)
    e0 = common.total_energy_per_atom(system, state)
    trace = []
    for i in range(blocks):
        state = system.run(state, n_steps=block_steps, dt_fs=DT_FS,
                           launch_chunks=LAUNCH_CHUNKS)
        trace.append(common.total_energy_per_atom(system, state) - e0)
        print(f"step {(i + 1) * block_steps}: drift {trace[-1]:.3e} "
              "eV/atom", flush=True)
    drift = abs(trace[-1])
    slope = float(np.polyfit(np.arange(1, blocks + 1, dtype=float),
                             np.asarray(trace), 1)[0])
    secular = abs(slope) * blocks
    result = {
        "config": {"n_atoms": len(geom), "n_respa": n_respa,
                   "respa_mid": respa_mid, "rebuild_every": rebuild,
                   "respa_switch_r_lo": r_lo,
                   "platform": common.platform(device)},
        "n_steps": blocks * block_steps,
        "drift_trace_ev_per_atom": trace,
        "final_drift_ev_per_atom": drift,
        "secular_heating_ev_per_atom_over_run": secular,
        "shadow_amplitude_ev_per_atom": float(np.max(np.abs(trace))),
        "criterion": CRITERION,
        "passes": bool(drift <= CRITERION),
        "passes_secular": bool(secular <= CRITERION),
    }
    if keep is not None:
        keep.update(system=system, state=state)
    return common.stamp(result, device, commit)


def artifact_name(n_respa, respa_mid, rebuild, r_lo=None) -> str:
    """``validate_final_12_6_36_lo25.json`` for 12 6 36 2.5, as the
    reference's kept artifacts are named."""
    lo = "" if r_lo is None else "_lo" + f"{r_lo:.1f}".replace(".", "")
    return f"validate_final_{n_respa}_{respa_mid}_{rebuild}{lo}.json"


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("cadence", type=float, nargs="*",
                        help="n_respa respa_mid rebuild [r_lo] (default 18 "
                             "6 36, no switch)")
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
    if len(args.cadence) > 4:
        parser.error("at most four positional arguments: n_respa "
                     "respa_mid rebuild r_lo")
    cadence = [int(x) for x in args.cadence[:3]]
    cadence += [18, 6, 36][len(cadence):]
    r_lo = args.cadence[3] if len(args.cadence) > 3 else None
    result = run(*cadence, r_lo, tuple(args.reps), device=args.device,
                 commit=args.commit)
    print(json.dumps(result))
    path = common.write_artifact(result, args.out_dir,
                                 artifact_name(*cadence, r_lo))
    print(f"wrote {path}")
    return result


if __name__ == "__main__":
    main()
