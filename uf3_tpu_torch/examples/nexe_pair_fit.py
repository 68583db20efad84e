"""
Binary Ne-Xe 2-body fit and its LAMMPS pair tables, on the CUDA card:
read a LAMMPS run directory (``log.lammps`` joined with
``dump.lammpstrj``; types 1 = Ne, 2 = Xe; ``TotEng`` as the energy),
featurize the three pairs' bases (r 1.0 to 8.0 A, resolution 20) on
the device, fit with curvature regularization 1e-8 (energy weight 0.5),
write the model to ``model_nexe.json`` and each pair as a ``pair_style
table`` file ``table_<A>_<B>.dat`` (200 grid points), all in
``--out-dir``.

    python -m uf3_tpu_torch.examples.nexe_pair_fit RUN_DIR [--out-dir DIR]
        [--cpu]

The Ne-Xe LAMMPS dataset is not in the repository; ``write_lammps_run``
writes a run directory of labeled configurations in the layout read
here.
"""

import argparse
import os

import numpy as np
import torch

from uf3_tpu_torch.data import io as data_io
from uf3_tpu_torch.data.composition import ChemicalSystem
from uf3_tpu_torch.forcefield import lammps
from uf3_tpu_torch.ops import featurize
from uf3_tpu_torch.regression.least_squares import WeightedLinearModel
from uf3_tpu_torch.representation.basis import BSplineBasis

ALIASES = {1: "Ne", 2: "Xe"}
COLUMN_SUBS = {"TotEng": "energy"}
GRID = 200


def pair_basis() -> BSplineBasis:
    chemistry = ChemicalSystem(["Ne", "Xe"], degree=2)
    pairs = chemistry.interactions_map[2]
    return BSplineBasis(chemistry,
                        r_min_map={p: 1.0 for p in pairs},
                        r_max_map={p: 8.0 for p in pairs},
                        resolution_map={p: 20 for p in pairs})


def write_lammps_run(run_dir, geometries, aliases=None):
    """A LAMMPS run directory of ``geometries`` (orthogonal or
    lower-triangular cells) as this example reads it: ``log.lammps``,
    one thermo block with each configuration's ``info["energy"]`` as
    PotEng and TotEng at steps 0, 10, ..., and ``dump.lammpstrj`` with
    its positions and forces at the same steps (types from ``aliases``,
    {type: symbol}, by default Ne and Xe)."""
    types = {symbol: t for t, symbol in (aliases or ALIASES).items()}
    os.makedirs(run_dir, exist_ok=True)
    rows, snapshots = [], []
    for i, geom in enumerate(geometries):
        cell = geom.get_cell()
        if np.any(np.triu(cell, 1)):
            raise ValueError("write_lammps_run takes orthogonal or "
                             "lower-triangular cells")
        (lx, _, _), (xy, ly, _), (xz, yz, lz) = cell
        tilts = (xy, xz, xy + xz)
        bounds = ((min(0.0, *tilts), lx + max(0.0, *tilts), xy),
                  (min(0.0, yz), ly + max(0.0, yz), xz), (0.0, lz, yz))
        energy = geom.info["energy"]
        rows.append(f"{10 * i} {energy:.17g} {energy:.17g}")
        lines = [f"ITEM: TIMESTEP\n{10 * i}\nITEM: NUMBER OF ATOMS\n"
                 f"{len(geom)}\nITEM: BOX BOUNDS xy xz yz pp pp pp"]
        lines += [" ".join(f"{x:.17g}" for x in b) for b in bounds]
        lines.append("ITEM: ATOMS id type x y z fx fy fz")
        forces = np.stack([geom.arrays[c] for c in ("fx", "fy", "fz")], 1)
        for j, (symbol, x, f) in enumerate(zip(
                geom.get_chemical_symbols(), geom.positions, forces)):
            lines.append(f"{j + 1} {types[symbol]} "
                         + " ".join(f"{v:.17g}" for v in (*x, *f)))
        snapshots.append("\n".join(lines) + "\n")
    with open(os.path.join(run_dir, "log.lammps"), "w") as f:
        f.write("LAMMPS\nunits metal\nStep PotEng TotEng\n"
                + "\n".join(rows) + f"\nLoop time of 0 on 1 procs for "
                f"{10 * (len(rows) - 1)} steps\n")
    with open(os.path.join(run_dir, "dump.lammpstrj"), "w") as f:
        f.write("".join(snapshots))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run_dir")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = torch.device("cpu") if args.cpu else None

    geometries = data_io.parse_lammps_outputs(args.run_dir, ALIASES,
                                              column_subs=COLUMN_SUBS)
    print(f"{len(geometries)} snapshots loaded")
    basis = pair_basis()
    featurizer = featurize.Featurizer(basis, device=device)
    x_e, y_e, x_f, y_f = featurizer.featurize_dataset(
        geometries, [g.info["energy"] for g in geometries],
        data_io.forces_of(geometries))
    print(f"features: {len(y_e)} energy rows, {len(y_f)} force rows "
          f"(route {featurizer.route})")
    model = WeightedLinearModel(basis, device=device, c2=1e-8)
    model.fit(x_e, y_e, x_f, y_f, weight=0.5)
    os.makedirs(args.out_dir, exist_ok=True)
    model_path = os.path.join(args.out_dir, "model_nexe.json")
    model.to_json(model_path)
    print(f"model written to {model_path}")
    sizes, offsets = basis.get_interaction_partitions()
    paths = []
    for pair in basis.chemical_system.interactions_map[2]:
        coeff = model.coefficients[offsets[pair]:offsets[pair] + sizes[pair]]
        path = os.path.join(args.out_dir, f"table_{'_'.join(pair)}.dat")
        lammps.export_tabulated_potential(basis.knots_map[pair], coeff, pair,
                                          grid=GRID, filename=path)
        paths.append(path)
        print(f"wrote {path}")
    return model, paths


if __name__ == "__main__":
    main()
