"""
End-to-end 2+3-body tungsten fit on the CUDA card: read an extended-xyz
dataset (the native tokenizer, ``data.io.read_sources``), featurize it
on the device in the manuscript's basis (r_max (W, W) = 5.5 A, (W, W, W)
= [3.5, 3.5, 7.0]; resolutions 15 and [6, 6, 12]; the default trims),
write the features as ``.npz``, fit the first 80% of the configurations
with curvature regularization (1e-8 on both degrees, energy weight
0.5), and report the other 20%'s energy and force RMSE.  The model goes
to ``model_2and3_refit.json`` and, where matplotlib imports, the 3-body
slice grid to ``slices_3b.png`` (both in ``--out-dir``).

    python -m uf3_tpu_torch.examples.tungsten_fit DATASET.xyz
        [FEATURES.npz] [--out-dir DIR] [--cpu]

The DFT tungsten set (w-14.xyz) is not in the repository.
"""

import argparse
import os
import time

import numpy as np
import torch

from uf3_tpu_torch.data import io as data_io
from uf3_tpu_torch.data.composition import ChemicalSystem
from uf3_tpu_torch.ops import featurize
from uf3_tpu_torch.regression.least_squares import (WeightedLinearModel,
                                                     rmse_metric)
from uf3_tpu_torch.representation.basis import BSplineBasis

PAIR, TRIO = ("W", "W"), ("W", "W", "W")
REGULARIZER = dict(c2=1e-8, c3=1e-8)
WEIGHT = 0.5
TRAIN_SHARE = 0.8


def manuscript_basis() -> BSplineBasis:
    return BSplineBasis(
        ChemicalSystem(["W"], degree=3),
        r_min_map={PAIR: 1.5, TRIO: [1.5, 1.5, 1.5]},
        r_max_map={PAIR: 5.5, TRIO: [3.5, 3.5, 7.0]},
        resolution_map={PAIR: 15, TRIO: [6, 6, 12]})


def rows_of(arrays, force_rows, configs):
    """(x_e, y_e, x_f, y_f) of the configurations ``configs`` (sorted
    indices into the features file)."""
    x_e, y_e, x_f, y_f = arrays
    starts = np.concatenate([[0], np.cumsum(force_rows)])
    f_idx = np.concatenate([np.arange(starts[i], starts[i + 1])
                            for i in configs]).astype(np.int64)
    return x_e[configs], y_e[configs], x_f[f_idx], y_f[f_idx]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dataset")
    ap.add_argument("features", nargs="?", default="features.npz")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = torch.device("cpu") if args.cpu else None

    t0 = time.perf_counter()
    keys, geometries = data_io.read_sources([args.dataset])
    print(f"{len(geometries)} configurations loaded in "
          f"{time.perf_counter() - t0:.3f} s")
    basis = manuscript_basis()
    featurizer = featurize.Featurizer(basis, device=device)
    energies = [g.info.get("energy", 0.0) for g in geometries]
    forces = data_io.forces_of(geometries)
    stats = {}
    t0 = time.perf_counter()
    arrays = featurizer.featurize_dataset(geometries, energies, forces,
                                          stats=stats)
    force_rows = featurizer.force_rows(geometries, forces)
    os.makedirs(os.path.dirname(os.path.abspath(args.features)),
                exist_ok=True)
    data_io.save_features(args.features, arrays, keys, geometries,
                          force_rows, basis.get_column_names())
    print(f"featurization: {time.perf_counter() - t0:.3f} s on "
          f"{featurizer.device} (route {featurizer.route}, {stats['calls']} "
          f"calls), written to {args.features}")

    split = int(TRAIN_SHARE * len(geometries))
    train, test = np.arange(split), np.arange(split, len(geometries))
    model = WeightedLinearModel(basis, device=device, **REGULARIZER)
    t0 = time.perf_counter()
    model.fit(*rows_of(arrays, force_rows, train), weight=WEIGHT)
    print(f"gram + solve: {time.perf_counter() - t0:.3f} s")
    x_e, y_e, x_f, y_f = rows_of(arrays, force_rows, test)
    rmse_e = rmse_metric(y_e, x_e @ model.coefficients)
    rmse_f = rmse_metric(y_f, x_f @ model.coefficients) if len(y_f) \
        else float("nan")
    print(f"holdout energy RMSE: {rmse_e * 1000:.2f} meV/atom "
          f"(per-atom basis), force RMSE: {rmse_f:.4f} eV/A "
          f"({len(test)} configurations)")
    os.makedirs(args.out_dir, exist_ok=True)
    model_path = os.path.join(args.out_dir, "model_2and3_refit.json")
    model.to_json(model_path)
    print(f"model written to {model_path}")
    # the multi-panel 3-body slice grid (r_ij x r_ik panels over r_jk)
    try:
        import matplotlib
        matplotlib.use("Agg")
        from uf3_tpu_torch.util.plotting import ThreeBodyPlotter
        fig, _ = ThreeBodyPlotter(model).plot_slices(n_panels=5)
        path = os.path.join(args.out_dir, "slices_3b.png")
        fig.savefig(path, dpi=140)
        print(f"3B slice grid written to {path}")
    except ImportError:
        pass
    return model, rmse_e, rmse_f


if __name__ == "__main__":
    main()
