"""
End-to-end 2+3-body tungsten fit on the CUDA card: read an extended-xyz
dataset (the native tokenizer, ``data.io.read_sources``), featurize it
on the device in the manuscript's basis (r_max (W, W) = 5.5 A, (W, W, W)
= [3.5, 3.5, 7.0]; resolutions 15 and [6, 6, 12]; the default trims),
write the features, fit the first 80% of the configurations with
curvature regularization (1e-8 on both degrees, energy weight 0.5),
and report the other 20%'s energy and force RMSE.  The features go to
``FEATURES.h5`` (the default, as the reference's example: the HDF5
store's tables of 50 configurations) or ``FEATURES.npz`` (the fitting
arrays); either is fitted with ``fit_from_file`` and scored with
``batched_predict``, table by table.  The model goes to
``model_2and3_refit.json`` and, where matplotlib imports, the 3-body
slice grid to ``slices_3b.png`` (both in ``--out-dir``).

    python -m uf3_tpu_torch.examples.tungsten_fit DATASET.xyz
        [FEATURES.h5 | FEATURES.npz] [--out-dir DIR] [--cpu]

The DFT tungsten set (w-14.xyz) is not in the repository.
"""

import argparse
import os
import time

import torch

from uf3_tpu_torch.data import io as data_io
from uf3_tpu_torch.data.composition import ChemicalSystem
from uf3_tpu_torch.ops import featurize
from uf3_tpu_torch.regression.least_squares import WeightedLinearModel
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


def report_featurization(featurizer, stats, t0, path):
    print(f"featurization: {time.perf_counter() - t0:.3f} s on "
          f"{featurizer.device} (route {featurizer.route}, {stats['calls']} "
          f"calls), written to {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dataset")
    ap.add_argument("features", nargs="?", default="features.h5")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = torch.device("cpu") if args.cpu else None

    basis = manuscript_basis()
    featurizer = featurize.Featurizer(basis, device=device)
    t0 = time.perf_counter()
    coordinator = data_io.DataCoordinator()
    data_io.parse_with_subsampling([args.dataset], coordinator)
    dataset = coordinator.consolidate()
    keys, geometries = dataset.keys, dataset["geometry"]
    print(f"{len(geometries)} configurations loaded in "
          f"{time.perf_counter() - t0:.3f} s")
    os.makedirs(os.path.dirname(os.path.abspath(args.features)),
                exist_ok=True)
    split = int(TRAIN_SHARE * len(geometries))
    model = WeightedLinearModel(basis, device=device, **REGULARIZER)
    stats = {}
    t0 = time.perf_counter()
    featurizer.write_features(args.features, dataset, stats=stats)
    report_featurization(featurizer, stats, t0, args.features)
    t0 = time.perf_counter()
    model.fit_from_file(args.features, subset=keys[:split], weight=WEIGHT)
    print(f"gram + solve: {time.perf_counter() - t0:.3f} s")
    *_, rmse_e, rmse_f = model.batched_predict(args.features,
                                               keys=keys[split:])
    print(f"holdout energy RMSE: {rmse_e * 1000:.2f} meV/atom "
          f"(per-atom basis), force RMSE: {rmse_f:.4f} eV/A "
          f"({len(geometries) - split} configurations)")
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
