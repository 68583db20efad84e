"""
NVE energy drift and a Langevin window's rate per 3-level r-RESPA
cadence (n_respa, rebuild, respa_mid).  Port of
``benchmarks/validate_respa_mid.py``.

For each configuration (by default 6:24:1, 6:24:2, 6:24:3 and 6:36:2)
the engine (bcc W 17^3 = 9,826 atoms, ``model_2and3.json``, float32,
skins 0.5 / 1.2 A, 72 / 16 slots) runs 7 x rebuild Langevin steps at 300
K, then 28 x rebuild NVE steps: the drift |E1 - E0| / N passes at 2e-4
eV/atom, the reference's criterion.  Then one 540-step Langevin window
in launches of 10 rebuild cycles without a sync at its end, after a warm
window of the same shape, is timed on the clock with the card waited for
before each read (``atom_steps_per_s_nvt``; no throughput claim: each
entry's ``card`` says which card at which power limit).  Each entry
merges into the artifact as it finishes.

    python -m uf3_tpu_torch.benchmarks.validate_respa_mid [n:rb:mid ...]
        [--device cpu]

writes ``benchmarks_data/artifacts_torch/validate_respa_mid.json``.
"""

import argparse
import json
import os
import time

import torch

from uf3_tpu_torch.benchmarks import common
from uf3_tpu_torch.forcefield.md import MDSystem

# benchmarks/validate_respa_mid.py:49-73
ENGINE = dict(skin=0.5, skin_2b=1.2, capacity_2b=72, capacity_3b=16)
CONFIGS = ((6, 24, 1), (6, 24, 2), (6, 24, 3), (6, 36, 2))
WARM_CYCLES = 7
NVE_CYCLES = 28
WINDOW_STEPS = 540
WINDOW_CHUNKS = 10
TEMPERATURE = 300.0
DT_FS = 2.0


def run(configs=CONFIGS, reps=common.VALIDATION_REPS,
        warm_cycles: int = WARM_CYCLES, nve_cycles: int = NVE_CYCLES,
        window_steps: int = WINDOW_STEPS, device=None,
        dtype=torch.float32, model=common.MODEL, velocities=None,
        out_path: str = None, commit: str = None,
        keep: dict = None) -> dict:
    """The sweep over ``configs`` ((n_respa, rebuild, respa_mid)), each
    from 300 K velocities (seed 0, or ``velocities``).  With
    ``out_path`` the entries merge into the JSON there (read first where
    it exists), written after each configuration.  ``keep``, where
    given, receives the last configuration's system and state."""
    device = common.resolve_device(device)
    geom = common.bcc_w(reps)
    n_atoms = len(geom)
    results = {"n_atoms": n_atoms,
               "platform": common.platform(device)}
    if out_path is not None and os.path.exists(out_path):
        with open(out_path) as f:
            results.update(json.load(f))
    common.stamp(results, device, commit)
    langevin = dict(dt_fs=DT_FS, thermostat="langevin",
                    temperature=TEMPERATURE)
    for n_respa, rb, mid in configs:
        key = f"respa{n_respa}_rb{rb}_mid{mid}"
        system = MDSystem(model, geom, dtype=dtype, device=device,
                          rebuild_every=rb, n_respa=n_respa, respa_mid=mid,
                          **ENGINE)
        state = system.init_state(velocities=velocities,
                                  temperature=TEMPERATURE, seed=0)
        if warm_cycles:
            state = system.run(state, n_steps=rb * warm_cycles, **langevin)
        e0 = common.total_energy_per_atom(system, state)
        n_steps = rb * nve_cycles
        state = system.run(state, n_steps=n_steps, dt_fs=DT_FS)
        drift = abs(common.total_energy_per_atom(system, state) - e0)
        stale_nve = bool(state.stale)
        # the timed window's own shape, warmed first
        window = dict(langevin, launch_chunks=WINDOW_CHUNKS, sync=False)
        state = system.run(state, n_steps=window_steps, **window)
        common.sync(device)
        t0 = time.perf_counter()
        state = system.run(state, n_steps=window_steps, **window)
        common.sync(device)
        seconds = time.perf_counter() - t0
        results[key] = {
            "nve_drift_eV_per_atom": drift,
            "nve_steps": n_steps,
            "stale_nve": stale_nve,
            "stale": bool(state.stale),
            "overflow": system.overflowed(state),
            "atom_steps_per_s_nvt": n_atoms * window_steps / seconds,
            "card": results["card"],
            "commit": results["commit"],
        }
        print(key, results[key], flush=True)
        if out_path is not None:
            common.write_artifact(results, os.path.dirname(out_path),
                                  os.path.basename(out_path))
    if keep is not None:
        keep.update(system=system, state=state)
    return results


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("configs", nargs="*",
                        help="n_respa:rebuild:respa_mid ... (default "
                             "6:24:1 6:24:2 6:24:3 6:36:2)")
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
    configs = [tuple(int(x) for x in a.split(":")) for a in args.configs] \
        or CONFIGS
    out_path = os.path.join(args.out_dir, "validate_respa_mid.json")
    result = run(configs, tuple(args.reps), device=args.device,
                 out_path=out_path, commit=args.commit)
    print(json.dumps(result))
    print(f"wrote {out_path}")
    return result


if __name__ == "__main__":
    main()
