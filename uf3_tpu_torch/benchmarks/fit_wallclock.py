"""
The fit path's wall time on the card: device featurization of a
tungsten-set-sized dataset and the weighted Gram and solve.  Port of
``benchmarks/fit_wallclock.py``.

The work: ``n_configs`` (1,939 by default, the size of the qmml.org
tungsten set, which is not bundled) rattled bcc W cells, 54 atoms (3^3)
in two of three and 128 (4^3) in the third (rattle 0.02-0.10 A by
``rattle(seed=i)``, energies and forces drawn from ``RandomState(0)``,
as the reference's), featurized by ``ops/featurize.py``'s
``featurize_dataset_device`` in float64 in the reference demo basis
(``featurize_throughput.demo_basis``) after a 4-configuration warm-up,
then fitted by ``WeightedLinearModel.fit(x_e, y_e, x_f, y_f,
weight=0.5)`` with c2 = c3 = 1e-8: the Gram matrices on the card in
float64, the solve on the host.

The reference also reports a 50 ms/config target set for the TPU; the
port carries no TPU figure, so no target.

    python -m uf3_tpu_torch.benchmarks.fit_wallclock [n_configs]
        [--device cpu]

writes ``benchmarks_data/artifacts_torch/fit_wallclock.json``.
"""

import argparse
import json
import time

import numpy as np

from uf3_tpu_torch.benchmarks import common
from uf3_tpu_torch.benchmarks.featurize_throughput import (demo_basis,
                                                           featurize_timed,
                                                           labels, rattled_w)
from uf3_tpu_torch.regression.least_squares import WeightedLinearModel

N_CONFIGS = 1939
WARM_CONFIGS = 4
REGULARIZER = dict(c2=1e-8, c3=1e-8)


def build_dataset(n_configs: int, seed: int = 0):
    """(geometries, energies, forces): 54-atom cells, and a 128-atom
    cell every third configuration from the first."""
    rng = np.random.RandomState(seed)
    geometries, energies, forces = [], [], []
    for i in range(n_configs):
        geom = rattled_w(i, (3, 3, 3) if i % 3 else (4, 4, 4))
        energy, force = labels(rng, len(geom))
        geometries.append(geom)
        energies.append(energy)
        forces.append(force)
    return geometries, energies, forces


def run(n_configs: int = N_CONFIGS, device=None, commit: str = None,
        keep: dict = None) -> dict:
    """The fit of ``n_configs`` configurations; ``keep``, where given,
    receives the rows and the fitted model."""
    device = common.resolve_device(device)
    basis = demo_basis()
    geometries, energies, forces = build_dataset(n_configs)
    rows, t_feat = featurize_timed(basis, geometries, energies, forces,
                                   WARM_CONFIGS, device)
    model = WeightedLinearModel(basis, device=device, **REGULARIZER)
    t0 = time.perf_counter()
    model.fit(*rows, weight=0.5)
    t_solve = time.perf_counter() - t0
    result = {
        "metric": "tungsten-scale fit (featurize + solve) wall-clock",
        "platform": common.platform(device),
        "n_configs": n_configs,
        "n_atoms_total": sum(len(g) for g in geometries),
        "n_force_rows": int(rows[2].shape[0]),
        "featurize_s": t_feat,
        "featurize_ms_per_config": 1e3 * t_feat / n_configs,
        "solve_s": t_solve,
        "total_s": t_feat + t_solve,
    }
    if keep is not None:
        keep.update(rows=rows, model=model)
    return common.stamp(result, device, commit)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("n_configs", type=int, nargs="?", default=N_CONFIGS)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--out-dir", default=common.ARTIFACTS)
    parser.add_argument("--commit", default=None,
                        help="the artifact's commit (default: git's short "
                             "commit)")
    args = parser.parse_args(argv)
    result = run(args.n_configs, device=args.device, commit=args.commit)
    print(json.dumps(result))
    path = common.write_artifact(result, args.out_dir, "fit_wallclock.json")
    print(f"wrote {path}")
    return result


if __name__ == "__main__":
    main()
