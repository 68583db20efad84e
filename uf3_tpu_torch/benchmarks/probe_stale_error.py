"""
The force error of a stale neighbor list, measured directly.  Port of
``benchmarks/probe_stale_error.py``.

The engine (bcc W 17^3 = 9,826 atoms, ``model_2and3.json``, 3-level
r-RESPA 9/3/27, 3-body skin from the command line (0.5 A), 2-body skin
1.2 A, 72 / 16 slots) runs 270 Langevin steps at 300 K.  The script then
freezes both lists at those positions x0 and advances the dynamics (with
its own rebuilds) in launches of 27 steps.  After each launch it
evaluates the forces at the new positions x1 on the frozen lists and on
lists built afresh, and records the largest single-atom drift from x0,
whether it passed the stale trip line (0.5 x the 3-body skin, the
single-atom line the reference uses), the largest |F_frozen - F_fresh|
and the rms force.  It stops once the drift passes 2.2 x the line, or
after 30 samples.  A frozen list can only miss a pair that came from
beyond r_cut + skin to within r_cut, where the spline and its derivative
vanish smoothly, so the error is what ``stale=True`` on a launch can
stand for.

Both lists are built for positions where they lie, in or out of the
cell, as the reference's ``build_lists(..., wrapped=False)`` builds
them: at the positions wrapped into the cell, each slot's image shift
then carried by its two atoms' lattice translations (``lists_at``), so
that the frozen and the fresh forces are sums over the same coordinates.
A full rebuild wraps the state's positions into the cell: an atom that
crossed a face comes back a lattice vector away.  The script takes x1
less the lattice translation that brings it nearest to x0, so that the
drift is the atom's true displacement and the frozen lists see
continuous positions.

The dtype is float32 on the card and float64 on the CPU by default, as
the reference picks it.  In float32 two sums over the same pairs in
another slot order differ by ~1e-6 eV/A, so only the float64 figure
measures the truncation; ``--dtype float64`` runs it on the card.

    python -m uf3_tpu_torch.benchmarks.probe_stale_error [SKIN]
        [--device cpu] [--dtype float64]

writes ``benchmarks_data/artifacts_torch/probe_stale_error.json``
(``probe_stale_error_float64.json`` for float64 on the card).
"""

import argparse
import json

import torch

from uf3_tpu_torch.benchmarks import common
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops import neighbors as nb

# benchmarks/probe_stale_error.py:49-55
ENGINE = dict(rebuild_every=27, skin_2b=1.2, capacity_2b=72,
              capacity_3b=16, n_respa=9, respa_mid=3)
SKIN = 0.5
WARM_STEPS = 270
MAX_SAMPLES = 30
STOP_FACTOR = 2.2
TEMPERATURE = 300.0
DT_FS = 2.0
# the bound the reference's throughput gate puts on a stale window's
# force error (benchmarks/throughput_gate.py:177-195)
GATE_BOUND = 1e-5


def nearest_image(x1, x0, cell):
    """x1 translated, atom by atom, by the lattice vector that brings it
    nearest to x0: positions continuous with x0 however often a full
    rebuild wrapped them."""
    frac = nb.cell_transform(x1 - x0, torch.linalg.inv(cell))
    return x1 - nb.cell_transform(torch.round(frac), cell)


def lists_at(system: MDSystem, positions, cell):
    """``system``'s (2-body, 3-body) lists for ``positions`` in or out of
    the cell: built at the positions wrapped into it, each slot's image
    shift then carried by the lattice translations of its two atoms
    (shift + n_i - n_j, where positions = wrapped + n @ cell)."""
    wrapped = nb.wrap_positions(positions, cell, system.pbc)
    n = torch.round(nb.cell_transform(positions - wrapped,
                                      torch.linalg.inv(cell)))

    def carried(nbr):
        return nbr._replace(shift=nbr.shift + n[:, None, :] - n[nbr.idx],
                            reference_positions=positions)

    nbr2, nbr3 = system.build_lists(wrapped, cell)
    return carried(nbr2), None if nbr3 is None else carried(nbr3)


def run(skin: float = SKIN, reps=common.VALIDATION_REPS,
        warm_steps: int = WARM_STEPS, max_samples: int = MAX_SAMPLES,
        device=None, dtype=None, model=common.MODEL, velocities=None,
        friction_ps: float = 2.0, engine: dict = None, callback=None,
        commit: str = None, keep: dict = None) -> dict:
    """The probe, in launches of one rebuild cycle.  ``dtype`` defaults
    to float32 on the card and float64 on the CPU; ``engine`` overrides
    ``ENGINE``.  ``callback(sample, x1, f_fresh, state)``, where given,
    sees each sample with its positions (continuous with x0), its fresh
    forces and the MD state; ``keep`` receives the system and its last
    state."""
    device = common.resolve_device(device)
    if dtype is None:
        dtype = torch.float32 if device.type == "cuda" else torch.float64
    geom = common.bcc_w(reps)
    system = MDSystem(model, geom, dtype=dtype, device=device, skin=skin,
                      **dict(ENGINE, **(engine or {})))
    state = system.init_state(velocities=velocities,
                              temperature=TEMPERATURE, seed=0)
    langevin = dict(dt_fs=DT_FS, thermostat="langevin",
                    temperature=TEMPERATURE, friction_ps=friction_ps)
    if warm_steps:
        state = system.run(state, n_steps=warm_steps, **langevin)
    cell = state.cell
    x0 = state.positions
    nbr2_0, nbr3_0 = lists_at(system, x0, cell)
    stale_line = 0.5 * system.skin
    branches0 = dict(system.rebuild_branches)
    samples = []
    drift = 0.0
    # beyond 2x the single-atom stale line: the top-2 criterion's worst
    # realizable drift at the 36-step production rebuild window
    while drift < STOP_FACTOR * stale_line and len(samples) < max_samples:
        state = system.run(state, n_steps=system.rebuild_every,
                           **langevin)
        x1 = nearest_image(state.positions, x0, cell)
        delta = x1 - x0
        d2 = torch.sum(delta * delta, dim=-1)
        drift = float(torch.sqrt(torch.max(d2)))
        top2 = float(torch.sum(torch.sqrt(torch.topk(d2, 2).values)))
        _, f_stale, _ = system.energy_forces(x1, nbr2_0, nbr3_0, cell=cell)
        nbr2_f, nbr3_f = lists_at(system, x1, cell)
        _, f_fresh, _ = system.energy_forces(x1, nbr2_f, nbr3_f, cell=cell)
        sample = {"max_drift_A": drift,
                  "past_stale_line": drift > stale_line,
                  "max_abs_force_error_eV_A": float(
                      torch.max(torch.abs(f_stale - f_fresh))),
                  "rms_force_eV_A": float(torch.sqrt(torch.mean(
                      f_fresh * f_fresh)))}
        samples.append(sample)
        if callback is not None:
            callback(sample, x1, f_fresh, state)
        print(dict(sample, top2_drift_A=top2, stale=bool(state.stale)),
              flush=True)
    worst = max((s["max_abs_force_error_eV_A"] for s in samples
                 if s["past_stale_line"]), default=None)
    result = {
        "platform": common.platform(device),
        "n_atoms": len(geom),
        "skin_3b": system.skin,
        "stale_threshold_A": stale_line,
        "samples": samples,
        "max_force_error_past_stale_line_eV_A": worst,
        "interpretation": "frozen-list force error at drift just past the "
                          "stale trip line; compare to the f32 "
                          "device-force tolerance 2e-4 eV/A and, in "
                          f"float64, to {GATE_BOUND:g} eV/A, the bound "
                          "the reference's throughput gate puts on a "
                          "stale window",
        "dtype": str(dtype).replace("torch.", ""),
        "rebuild_branches": {key: n - branches0[key] for key, n in
                             system.rebuild_branches.items()},
    }
    if keep is not None:
        keep.update(system=system, state=state)
    return common.stamp(result, device, commit)


def artifact_name(device: torch.device, dtype: torch.dtype) -> str:
    """The reference's name for its default dtype, a suffixed one for
    float64 on the card."""
    if device.type == "cuda" and dtype == torch.float64:
        return "probe_stale_error_float64.json"
    return "probe_stale_error.json"


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("skin", type=float, nargs="?", default=SKIN,
                        help="the 3-body skin, A (default 0.5)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--dtype", choices=("float32", "float64"),
                        default=None, help="default: float32 on the card, "
                                           "float64 on the CPU")
    parser.add_argument("--reps", type=int, nargs=3,
                        default=common.VALIDATION_REPS,
                        help="bcc W supercell (default 17 17 17)")
    parser.add_argument("--out-dir", default=common.ARTIFACTS)
    parser.add_argument("--commit", default=None,
                        help="the artifact's commit (default: git's short "
                             "commit)")
    args = parser.parse_args(argv)
    dtype = None if args.dtype is None else getattr(torch, args.dtype)
    result = run(args.skin, tuple(args.reps), device=args.device,
                 dtype=dtype, commit=args.commit)
    print(json.dumps({k: v for k, v in result.items() if k != "samples"}))
    path = common.write_artifact(result, args.out_dir, artifact_name(
        common.resolve_device(args.device), getattr(torch, result["dtype"])))
    print(f"wrote {path}")
    return result


if __name__ == "__main__":
    main()
