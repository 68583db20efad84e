"""
Command line of the port: a quick MD run on the CUDA card, and the
LAMMPS export of a model.

    python -m uf3_tpu_torch md model.json [options]
    python -m uf3_tpu_torch export model.json [--out DIR]

``md`` takes the same flags, defaults and result line as ``python -m
uf3_tpu md`` (2,000 atoms of bcc, 1,000 steps of 2 fs, Langevin at
300 K, plain velocity Verlet unless ``--respa`` is given; ``--traj``
writes an extended-xyz frame per launch), plus ``--device``, which
defaults to the card.  ``export`` writes the native ``pair_style uf3``
file and prints its ``pair_style`` / ``pair_coeff`` lines, on the host.
The other subcommands of ``uf3_tpu`` are not ported yet and raise
NotImplementedError naming their ROADMAP.md item.
"""

import argparse
import time

import torch

from uf3_tpu_torch import io
from uf3_tpu_torch.data.atoms import bulk
from uf3_tpu_torch.forcefield import lammps
from uf3_tpu_torch.forcefield.batch import TrajectoryWriter
from uf3_tpu_torch.forcefield.md import MDSystem, _not_ported

NOT_PORTED = {"featurize": "Featurization", "fit": "Featurization",
              "predict": "Featurization"}


def cmd_md(model_path: str, args) -> None:
    element = io.load_model(model_path).bspline_config.element_list[0]
    atoms = bulk(element, "bcc", a=args.lattice) * args.reps
    print(f"{len(atoms)} atoms of {element}")
    system = MDSystem(model_path, atoms, dtype=torch.float32,
                      n_respa=args.respa, respa_mid=args.respa_mid,
                      static_rebuild=args.static_rebuild,
                      device=args.device)
    state = system.init_state(temperature=args.temperature)
    callback = None
    if args.traj:
        callback = TrajectoryWriter(args.traj, system)
    t0 = time.time()
    state = system.run(state, n_steps=args.steps, dt_fs=args.dt,
                       thermostat="langevin",
                       temperature=args.temperature,
                       callback=callback)
    if system.device.type == "cuda":
        torch.cuda.synchronize(system.device)
    elapsed = time.time() - t0
    print(f"{args.steps} steps in {elapsed:.2f} s "
          f"({len(atoms) * args.steps / elapsed:.3e} atom-steps/s); "
          f"T = {system.temperature(state):.0f} K, "
          f"E = {float(state.energy):.3f} eV")


def cmd_export(model_path: str, out_dir: str) -> None:
    model = io.load_model(model_path)
    path = lammps.write_uf3_lammps_pot_files(model=model, pot_dir=out_dir)
    print(f"potential written to {path}")
    print(lammps.generate_lammps_input(model, path))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="uf3_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    for name in ("featurize", "fit", "predict"):
        sub.add_parser(name).add_argument("settings")
    p_md = sub.add_parser("md")
    p_md.add_argument("model")
    p_md.add_argument("--reps", type=int, default=10)
    p_md.add_argument("--lattice", type=float, default=3.1652)
    p_md.add_argument("--steps", type=int, default=1000)
    p_md.add_argument("--dt", type=float, default=2.0)
    p_md.add_argument("--temperature", type=float, default=300.0)
    p_md.add_argument("--respa", type=int, default=1,
                      help="r-RESPA inner steps per outer step "
                           "(1 = plain velocity Verlet)")
    p_md.add_argument("--respa-mid", type=int, default=1,
                      help="3-level r-RESPA: inner steps per mid "
                           "(3-body force) step; must divide --respa")
    p_md.add_argument("--static-rebuild", "--static_rebuild",
                      action="store_true",
                      help="unconditional full neighbor rebuild every "
                           "cycle")
    p_md.add_argument("--traj", default=None,
                      help="write an extended-xyz trajectory (one "
                           "frame per launch) to this path")
    p_md.add_argument("--device", default=None,
                      help="torch device; the CUDA card by default")
    p_export = sub.add_parser("export")
    p_export.add_argument("model")
    p_export.add_argument("--out", default=".")
    return p


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    if args.command == "md":
        cmd_md(args.model, args)
    elif args.command == "export":
        cmd_export(args.model, args.out)
    else:
        raise _not_ported(f"the {args.command} command",
                          NOT_PORTED[args.command])


if __name__ == "__main__":
    main()
