"""
NVE energy drift per 2-level r-RESPA depth and the staleness flag at
longer rebuild cadences.  Port of ``benchmarks/validate_respa.py``.

For each (n_respa, rebuild) of (3, 18), (4, 24), (6, 24) and (6, 36) the
engine (bcc W 17^3 = 9,826 atoms, ``model_2and3.json``, float32, skins
0.5 / 1.2 A, 72 / 16 slots) runs 7 x rebuild Langevin steps at 300 K,
then 28 x rebuild NVE steps.  The drift |E1 - E0| / N passes at 2e-4
eV/atom, the reference's criterion.  ``stale`` and ``overflow`` are read
after the NVE run; ``atom_steps_per_s_nve`` is its rate on the clock,
the card waited for before each read (no throughput claim: the
artifact's ``card`` says which card at which power limit).

    python -m uf3_tpu_torch.benchmarks.validate_respa [--device cpu]

writes ``benchmarks_data/artifacts_torch/validate_respa.json``.
"""

import argparse
import json
import time

import torch

from uf3_tpu_torch.benchmarks import common
from uf3_tpu_torch.forcefield.md import MDSystem

# benchmarks/validate_respa.py:39-50
ENGINE = dict(skin=0.5, skin_2b=1.2, capacity_2b=72, capacity_3b=16)
CONFIGS = ((3, 18), (4, 24), (6, 24), (6, 36))
WARM_CYCLES = 7
NVE_CYCLES = 28
TEMPERATURE = 300.0
DT_FS = 2.0


def run(configs=CONFIGS, reps=common.VALIDATION_REPS,
        warm_cycles: int = WARM_CYCLES, nve_cycles: int = NVE_CYCLES,
        device=None, dtype=torch.float32, model=common.MODEL,
        velocities=None, commit: str = None, keep: dict = None) -> dict:
    """The sweep over ``configs`` ((n_respa, rebuild) pairs), each from
    300 K velocities (seed 0, or ``velocities``).  ``keep``, where
    given, receives the last configuration's system and state."""
    device = common.resolve_device(device)
    geom = common.bcc_w(reps)
    n_atoms = len(geom)
    results = {"n_atoms": n_atoms,
               "platform": common.platform(device)}
    for n_respa, rb in configs:
        system = MDSystem(model, geom, dtype=dtype, device=device,
                          rebuild_every=rb, n_respa=n_respa, **ENGINE)
        state = system.init_state(velocities=velocities,
                                  temperature=TEMPERATURE, seed=0)
        if warm_cycles:
            state = system.run(state, n_steps=rb * warm_cycles,
                               dt_fs=DT_FS, thermostat="langevin",
                               temperature=TEMPERATURE)
        e0 = common.total_energy_per_atom(system, state)
        n_steps = rb * nve_cycles
        common.sync(device)
        t0 = time.perf_counter()
        state = system.run(state, n_steps=n_steps, dt_fs=DT_FS)
        common.sync(device)
        seconds = time.perf_counter() - t0
        drift = abs(common.total_energy_per_atom(system, state) - e0)
        results[f"respa{n_respa}_rb{rb}"] = {
            "nve_drift_eV_per_atom": drift,
            "nve_steps": n_steps,
            "stale": bool(state.stale),
            "overflow": system.overflowed(state),
            "atom_steps_per_s_nve": n_atoms * n_steps / seconds,
        }
        print(f"respa{n_respa}_rb{rb}: drift {drift:.2e} eV/atom, "
              f"stale={bool(state.stale)}", flush=True)
    if keep is not None:
        keep.update(system=system, state=state)
    return common.stamp(results, device, commit)


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
    result = run(reps=tuple(args.reps), device=args.device,
                 commit=args.commit)
    print(json.dumps(result, indent=1))
    path = common.write_artifact(result, args.out_dir, "validate_respa.json")
    print(f"wrote {path}")
    return result


if __name__ == "__main__":
    main()
