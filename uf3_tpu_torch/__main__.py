"""
Command line of the port: the fit pipeline, a quick MD run on the CUDA
card, and the LAMMPS export of a model.

    python -m uf3_tpu_torch featurize settings.json  sources -> features.npz
    python -m uf3_tpu_torch fit settings.json        features -> model JSON
    python -m uf3_tpu_torch predict settings.json    RMSE of the model
    python -m uf3_tpu_torch md model.json [options]
    python -m uf3_tpu_torch export model.json [--out DIR]

``featurize``, ``fit`` and ``predict`` read the settings of ``python -m
uf3_tpu``'s commands, written as JSON (``util/user_config.py``); the
sources are extended-xyz files, featurized on the route the basis allows
(``ops/featurize.Featurizer``: the unary or the multi-species path on
the device, or the host featurizer for knots with no closed form; a
configuration without forces gives its energy row alone), and the
features file is ``.npz`` (x_e, y_e, x_f, y_f, the configuration keys,
sizes and force rows, the column names) where ``uf3_tpu`` writes HDF5.  ``md`` takes the same flags, defaults and
result line as ``python -m uf3_tpu md`` (2,000 atoms of bcc, 1,000
steps of 2 fs, Langevin at 300 K, plain velocity Verlet unless
``--respa`` is given; ``--traj`` writes an extended-xyz frame per
launch).  Every command but ``export`` takes ``--device``, which
defaults to the card.  ``export`` writes the native ``pair_style uf3``
file and prints its ``pair_style`` / ``pair_coeff`` lines, on the host.
What is not ported yet raises NotImplementedError naming its ROADMAP.md
item.
"""

import argparse
import time

import numpy as np
import torch

from uf3_tpu_torch import io
from uf3_tpu_torch.data import io as data_io
from uf3_tpu_torch.data.atoms import bulk
from uf3_tpu_torch.forcefield import lammps
from uf3_tpu_torch.forcefield.batch import TrajectoryWriter
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.regression import least_squares as ls
from uf3_tpu_torch.util import user_config

ROUTES = {"device": "the unary 2+3-body path on the device",
          "device multi": "the multi-species path on the device",
          "host": "the host featurizer: knots with no closed form"}


def cmd_featurize(settings_path: str, device=None) -> None:
    settings = user_config.read_config(settings_path)
    handlers = user_config.generate_handlers(settings, device=device)
    features_path = data_io.npz_features_path(
        settings["features"]["features_path"])
    sources = settings["data"]["sources"]
    paths = data_io.identify_paths(experiment_path=sources.get("path", "."),
                                   filename_pattern=sources.get("pattern"))
    keys, geometries = data_io.read_sources(
        paths, max_samples=settings["data"].get("max_per_file", -1),
        min_diff=settings["data"].get("min_diff", 0.0))
    print(f"{len(geometries)} configurations")
    energies = [g.info.get("energy", 0.0) for g in geometries]
    # a configuration without forces gives its energy row alone
    forces = data_io.forces_of(geometries)
    featurizer = handlers["features"]
    print(f"route: {featurizer.route} ({ROUTES[featurizer.route]})")
    stats = {}
    arrays = featurizer.featurize_dataset(geometries, energies, forces,
                                          stats=stats)
    force_rows = featurizer.force_rows(geometries, forces)
    data_io.save_features(features_path, arrays, keys, geometries,
                          force_rows, handlers["basis"].get_column_names())
    print(f"features written to {features_path} ({len(arrays[1])} energy "
          f"rows, {len(arrays[3])} force rows; {stats['calls']} calls, "
          f"{stats['redos']} configurations redone at their measured "
          "neighbor count)")


def cmd_fit(settings_path: str, device=None) -> None:
    settings = user_config.read_config(settings_path)
    handlers = user_config.generate_handlers(settings, device=device)
    x_e, y_e, x_f, y_f = data_io.load_features(
        settings["learning"]["features_path"])
    model = handlers["learning"]
    if x_e.shape[1] != model.n_feats:
        raise ValueError(f"{x_e.shape[1]} feature columns, the basis has "
                         f"{model.n_feats}")
    model.fit(x_e, y_e, x_f, y_f,
              weight=settings["learning"].get("weight", 0.5))
    model_path = settings["model"]["model_path"]
    model.to_json(model_path)
    print(f"model written to {model_path}")


def cmd_predict(settings_path: str, device=None) -> None:
    settings = user_config.read_config(settings_path)
    handlers = user_config.generate_handlers(settings, device=device)
    x_e, y_e, x_f, y_f = data_io.load_features(
        settings["learning"]["features_path"])
    model = handlers.get("model")
    if model is None:
        model = ls.WeightedLinearModel.from_json(
            settings["model"]["model_path"], device=device)

    def predict(x):
        return model.predict(torch.as_tensor(
            x, dtype=torch.float64, device=model.device)).cpu().numpy()

    rmse_e = ls.rmse_metric(y_e, predict(x_e))
    # no force row (fit_forces off, or no configuration with forces)
    rmse_f = ls.rmse_metric(y_f, predict(x_f)) if len(y_f) else np.nan
    print(f"RMSE (energy): {rmse_e:.3F}\nRMSE (forces): {rmse_f:.3F}")
    print(f"RMSE (energy, eV/atom): {rmse_e:.6e}; RMSE (forces, eV/A): "
          f"{rmse_f:.6e}; {len(y_e)} configurations, {len(y_f)} force "
          f"rows on {model.device}")


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


FIT_COMMANDS = {"featurize": cmd_featurize, "fit": cmd_fit,
                "predict": cmd_predict}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="uf3_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    for name in FIT_COMMANDS:
        p_fit = sub.add_parser(name)
        p_fit.add_argument("settings")
        p_fit.add_argument("--device", default=None,
                           help="torch device; the CUDA card by default")
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
        FIT_COMMANDS[args.command](args.settings, device=args.device)


if __name__ == "__main__":
    main()
