"""
Two-phase melting-point trial of bcc tungsten on the CUDA card, after
the LAMMPS protocol of the UF3 paper's melting-point application
(``melting_uf.in``): equilibrate a long bcc box at the trial
temperature under NPT, melt one half with the other half pinned
(effectively infinite masses), re-cool the molten half, release
everything under NPT, and watch which phase grows through an x-binned
Bragg order profile.

- ``order_profile``: per x-bin, the Bragg amplitude |S| averaged over
  the three {110} harmonics of the supercell, from fractional
  coordinates (so the barostat's isotropic rescaling leaves it as it
  is); solid bins read |S| ~ exp(-W), liquid bins ~ 1 / sqrt(atoms in
  the bin).
- ``solid_fraction``: the share of bins above 0.25.
- ``run_trial``: the trial at one temperature, on the fitted 2+3-body W
  model, in float32 with the protocol's engine settings.  (1) Langevin
  at T with capacity regrowth, then SCR NPT at T, P = 0.  (2) The atoms
  at fractional x < 0.5 pinned (masses 1e12, zero velocity), SCR NPT at
  max(1.5 T, 8,000 K) (friction 10 / ps), then at T; where the solid
  fraction after re-cooling stays above 0.82 the melt runs again up to
  three times in all, each 2,500 K hotter; a start outside [0.25, 0.82]
  is "prep_failed".  (3) Everything released under SCR NPT at T in
  chunks of up to 2,000 steps, the system built again at the current
  cell once its x edge shrinks below 0.99 of the last build's; it stops
  once the solid fraction has moved more than 0.15 from its start.  The
  verdict: "grew" (T below the model's melting point), "shrank" (above)
  or "flat", at a change of 0.1.  Each stage's system is built from the
  current positions and cell with the capacities grown so far, its
  Langevin noise from a seed of its own.

The log carries the reference's keys (``benchmarks/melting_run.py``,
``run_trial``) and ``n_pinned``, ``obs_steps_run``, ``obs_rebuilds`` and
``wall_s``;
``obs_atom_steps_per_s`` counts the release steps that ran.

    python -m uf3_tpu_torch.examples.melting_point [T_K] [OBS_STEPS]
        [--reps X Y Z] [--prep-scale S] [--seed N] [--model PATH] [--cpu]

Defaults: 3,000 K, 8,000 release steps, reps (32, 12, 12) = 9,216
atoms, ``benchmarks_data/model_2and3.json``.  The last line printed is
the log as JSON.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from uf3_tpu_torch.data.atoms import Atoms, bulk
from uf3_tpu_torch.forcefield.md import MDSystem

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODEL = os.path.join(REPO, "benchmarks_data", "model_2and3.json")
A0 = 3.1652  # bcc W lattice constant of the fitted model
# 2-body radius 5.5 + 1.2 = 6.7 A holds 64 bcc neighbors at the 0 K
# lattice (88 leaves room for the liquid's density); 3-body 3.5 + 0.6 =
# 4.1 A holds 14 (20 ditto)
ENGINE = dict(rebuild_every=16, skin=0.6, skin_2b=1.2, capacity_2b=88,
              capacity_3b=20)
SOLID_THRESHOLD = 0.25
START_BAND = (0.25, 0.82)   # the solid fraction a release may start from
MELT_FLOOR_K = 8000.0
MELT_STEP_K = 2500.0
MELT_ATTEMPTS = 3
EARLY_STOP = 0.15
VERDICT_DELTA = 0.1
OBS_CHUNK = 2000


def order_profile(positions, cell, n_bins, reps=None):
    """Per-x-bin Bragg amplitude |S| averaged over the three {110}
    harmonics of the supercell, from fractional coordinates.  ``reps``,
    the conventional cells per axis, is the construction's: derived from
    an expanded cell it flips to the wrong harmonic once the expansion
    passes half a cell."""
    pos = np.asarray(positions, dtype=np.float64)
    cell = np.asarray(cell, dtype=np.float64)
    frac = pos @ np.linalg.inv(cell)
    frac -= np.floor(frac)
    if reps is None:
        reps = np.rint(np.linalg.norm(cell, axis=1) / A0).astype(int)
    hs = [(0, reps[1], reps[2]), (reps[0], 0, reps[2]),
          (reps[0], reps[1], 0)]
    bins = np.clip((frac[:, 0] * n_bins).astype(int), 0, n_bins - 1)
    prof = np.zeros(n_bins)
    for b in range(n_bins):
        sel = frac[bins == b]
        if len(sel) == 0:
            continue
        amps = [np.abs(np.exp(2j * np.pi * (sel @ np.asarray(h)))
                       .mean()) for h in hs]
        prof[b] = float(np.mean(amps))
    return prof


def solid_fraction(prof, threshold=SOLID_THRESHOLD):
    return float(np.mean(prof > threshold))


def _host(x) -> np.ndarray:
    return x.detach().double().cpu().numpy()


def _rebuilt(model, numbers, state, kw, capacities, masses=None):
    """A system at the state's positions and cell with ``capacities``
    (2-body, 3-body)."""
    atoms = Atoms(numbers, _host(state.positions), _host(state.cell),
                  pbc=True)
    return MDSystem(model, atoms, masses=masses, **dict(
        kw, capacity_2b=capacities[0], capacity_3b=capacities[1]))


def _profile(state, n_bins, reps):
    return order_profile(_host(state.positions), _host(state.cell), n_bins,
                         reps=reps)


def run_trial(model, trial_t, reps, n_obs, seed=0, prep_scale=1.0,
              dtype=torch.float32, device=None, verbose=True, keep=None):
    """One two-phase trial at ``trial_t`` K on a bcc W box of ``reps``
    conventional cells; ``prep_scale`` scales the preparation stages'
    steps (2,000 Langevin, 3,000 NPT, 10,000 melt, 8,000 re-cool), at
    least 24 / 32 each.  Returns the log; ``keep``, a dict, receives the
    last stage's ``system`` and ``state``."""
    say = print if verbose else (lambda *a, **k: None)
    t_start = time.perf_counter()
    atoms = bulk("W", "bcc", a=A0) * tuple(reps)
    numbers = atoms.get_atomic_numbers()
    n = len(atoms)
    kw = dict(ENGINE, dtype=dtype, device=device)
    n_bins = 2 * reps[0]
    npt = dict(dt_fs=2.0, pressure=0.0, launch_chunks=8)
    log = {"T": trial_t, "n_atoms": n}

    # (1) the whole box at the trial temperature, then its volume under
    # NPT: a verdict at the 0 K lattice density means nothing
    system = MDSystem(model, atoms, **kw)
    state = system.init_state(temperature=trial_t, seed=seed)
    state = system.run(state, n_steps=max(24, int(2000 * prep_scale)),
                       dt_fs=2.0, thermostat="langevin",
                       temperature=trial_t, on_overflow="regrow",
                       launch_chunks=8)
    state, _ = system.npt_run(state, n_steps=max(32, int(3000 * prep_scale)),
                              temperature=trial_t, **npt)
    log["cell_x_after_equil"] = float(state.cell[0, 0])

    # (2) the left half pinned; the right half melted under the SCR
    # barostat (at fixed volume the nascent liquid is compressed until
    # the pinned template seeds the solid again), then re-cooled.
    # Isotropic scaling deforms the pinned half affinely and leaves its
    # fractional coordinates, and so the order profile, as they are.
    frac_x = (_host(state.positions)
              @ np.linalg.inv(_host(state.cell)))[:, 0] % 1.0
    frozen = frac_x < 0.5
    masses = _host(system.masses).copy()
    masses[frozen] = 1e12
    pinned = _rebuilt(model, numbers, state, kw,
                      (system.capacity_2b, system.capacity_3b), masses)
    velocities = state.velocities.clone()
    velocities[torch.as_tensor(frozen, device=velocities.device)] = 0.0
    state = pinned.init_state(velocities=velocities, seed=seed + 1)
    log["n_pinned"] = int(frozen.sum())
    # hot enough to liquefy the mobile half within ~20 ps at any trial
    # temperature: at 5,500 K this model's mobile half stays a
    # superheated crystal on the pinned template for 20+ ps
    melt_t = max(1.5 * trial_t, MELT_FLOOR_K)
    for attempt in range(MELT_ATTEMPTS):
        state, _ = pinned.npt_run(
            state, n_steps=max(32, int(10000 * prep_scale)),
            temperature=melt_t, friction_ps=10.0, **npt)
        log["profile_hot"] = [round(float(p), 3) for p in
                              _profile(state, n_bins, reps)]
        log["melt_t"] = melt_t
        log["t_mobile_hot"] = round(pinned.temperature(state), 1)
        state, _ = pinned.npt_run(
            state, n_steps=max(32, int(8000 * prep_scale)),
            temperature=trial_t, friction_ps=10.0, **npt)
        prof0 = _profile(state, n_bins, reps)
        log["profile_after_melt"] = [round(float(p), 3) for p in prof0]
        sf0 = solid_fraction(prof0)
        log["solid_fraction_start"] = sf0
        # near or below the melting point the re-cool regrows part of
        # the molten half from the template however hot the melt ran;
        # the verdict reads the change, so a start up to 0.82 resolves
        if sf0 <= START_BAND[1] or attempt == MELT_ATTEMPTS - 1:
            break
        melt_t += MELT_STEP_K
        say(f"  T={trial_t:.0f}: melt survived at {melt_t - MELT_STEP_K:.0f}"
            f" K (sf {sf0:.2f}), escalating to {melt_t:.0f} K", flush=True)
    if keep is not None:
        keep.update(system=pinned, state=state)
    if not START_BAND[0] <= sf0 <= START_BAND[1]:
        log["verdict"] = "prep_failed"
        log["wall_s"] = time.perf_counter() - t_start
        return log

    # (3) everything released under NPT at the trial temperature
    capacities = (pinned.capacity_2b, pinned.capacity_3b)
    system = _rebuilt(model, numbers, state, kw, capacities)
    state = system.init_state(velocities=state.velocities, seed=seed + 2)
    sf_series = [sf0]
    obs_chunk = max(32, min(OBS_CHUNK, n_obs))
    cell_ref = float(state.cell[0, 0])
    rebuilds = 0
    t0 = time.perf_counter()
    done = 0
    while done < n_obs:
        state, _ = system.npt_run(state, n_steps=obs_chunk,
                                  temperature=trial_t, **npt)
        done += obs_chunk
        # the cell-list geometry is chosen at construction: it holds as
        # the box expands, not as it shrinks, so a denser box (a growing
        # solid) gets a system built at its own cell
        if float(state.cell[0, 0]) < 0.99 * cell_ref:
            capacities = (system.capacity_2b, system.capacity_3b)
            for attempt in range(4):
                rebuilds += 1
                system = _rebuilt(model, numbers, state, kw, capacities)
                try:
                    state = system.init_state(velocities=state.velocities,
                                              seed=seed + 2 + rebuilds)
                    break
                except ValueError:
                    if attempt == 3:
                        raise
                    capacities = tuple(int(c * 1.3) + 1 for c in capacities)
            cell_ref = float(state.cell[0, 0])
            say(f"  T={trial_t:.0f}: rebuilt bin geometry at cell_x "
                f"{cell_ref:.2f} A", flush=True)
        sf_series.append(solid_fraction(_profile(state, n_bins, reps)))
        say(f"  T={trial_t:.0f}: {done} steps, solid fraction "
            f"{sf_series[-1]:.2f}", flush=True)
        if abs(sf_series[-1] - sf0) > EARLY_STOP:
            break   # decided (the verdict's 0.1 with a margin)
    if keep is not None:
        keep.update(system=system, state=state)
    log["obs_steps"] = n_obs
    log["obs_steps_run"] = done
    log["obs_rebuilds"] = rebuilds
    log["obs_atom_steps_per_s"] = round(
        n * done / (time.perf_counter() - t0), 1)
    log["solid_fraction_series"] = [round(s, 3) for s in sf_series]
    delta = sf_series[-1] - sf0
    log["verdict"] = ("grew" if delta > VERDICT_DELTA else
                      "shrank" if delta < -VERDICT_DELTA else "flat")
    log["wall_s"] = time.perf_counter() - t_start
    return log


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trial_t", nargs="?", type=float, default=3000.0)
    ap.add_argument("n_obs", nargs="?", type=int, default=8000)
    ap.add_argument("--reps", nargs=3, type=int, default=[32, 12, 12])
    ap.add_argument("--prep-scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model", default=MODEL)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    log = run_trial(args.model, args.trial_t, tuple(args.reps), args.n_obs,
                    seed=args.seed, prep_scale=args.prep_scale,
                    device="cpu" if args.cpu else None)
    print(f"T = {args.trial_t:.0f} K, {log['n_atoms']} atoms: "
          f"verdict = {log['verdict']}")
    if "solid_fraction_series" in log:
        print("solid fraction over the release stage:",
              log["solid_fraction_series"])
        print("(grew -> T below melting; shrank -> T above)")
    print(json.dumps(log))
    return log


if __name__ == "__main__":
    main()
