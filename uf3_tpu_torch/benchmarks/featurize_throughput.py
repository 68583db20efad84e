"""
Device featurization throughput on the card: seconds per configuration
for fit-shaped work.  Port of ``benchmarks/featurize_throughput.py``.

The work: ``n_configs`` (64 by default) rattled bcc W cells of 4^3 =
128 atoms (rattle 0.02-0.10 A by ``rattle(seed=i)``, energies and
forces drawn from ``RandomState(0)``, as the reference's), featurized
by ``ops/featurize.py``'s ``featurize_dataset_device`` in float64 in the
reference demo basis: 2-body 1.5-5.5 A in 25 intervals, 3-body legs up
to (3.5, 3.5, 7.0) A in (6, 6, 12).  A 2-configuration prefix warms the
path first; the clock stops once the rows are on the host.

The reference prints its time beside a 50 ms/config target that was
set for the TPU; the port carries no TPU figure, so no target.

    python -m uf3_tpu_torch.benchmarks.featurize_throughput [n_configs]
        [--device cpu]

writes ``benchmarks_data/artifacts_torch/featurize_throughput.json``.
"""

import argparse
import json
import time

import numpy as np

from uf3_tpu_torch.benchmarks import common
from uf3_tpu_torch.data.composition import ChemicalSystem
from uf3_tpu_torch.ops.featurize import featurize_dataset_device
from uf3_tpu_torch.representation.basis import BSplineBasis

N_CONFIGS = 64
WARM_CONFIGS = 2


def demo_basis() -> BSplineBasis:
    """The reference demo basis of both fit-path scripts
    (``benchmarks/featurize_throughput.py:50-56``)."""
    return BSplineBasis(
        ChemicalSystem(["W"], degree=3),
        r_min_map={("W", "W"): 1.5, ("W", "W", "W"): [1.5, 1.5, 1.5]},
        r_max_map={("W", "W"): 5.5, ("W", "W", "W"): [3.5, 3.5, 7.0]},
        resolution_map={("W", "W"): 25, ("W", "W", "W"): [6, 6, 12]})


def rattled_w(i: int, reps):
    """Configuration ``i``: bcc W ``reps`` rattled by 0.02-0.10 A (seed
    i), as both reference scripts make it."""
    geom = common.bcc_w(reps)
    geom.rattle(0.02 + 0.08 * (i % 5) / 4, seed=i)
    return geom


def labels(rng, n_atoms: int):
    """An energy and (N, 3) forces drawn from ``rng`` as the reference
    draws them (the forces as a (3, N) draw, transposed)."""
    energy = float(rng.normal(-11.0, 0.1) * n_atoms)
    return energy, (rng.normal(size=(3, n_atoms)) * 0.5).T


def build_dataset(n_configs: int, seed: int = 0):
    """(geometries, energies, forces) of ``n_configs`` 128-atom cells."""
    rng = np.random.RandomState(seed)
    geometries, energies, forces = [], [], []
    for i in range(n_configs):
        geom = rattled_w(i, (4, 4, 4))
        energy, force = labels(rng, len(geom))
        geometries.append(geom)
        energies.append(energy)
        forces.append(force)
    return geometries, energies, forces


def featurize_timed(basis, geometries, energies, forces, warm: int,
                    device):
    """Featurize the first ``warm`` configurations, then time the whole
    set to its rows on the host.  Returns ((x_e, y_e, x_f, y_f),
    seconds)."""
    featurize_dataset_device(basis, geometries[:warm], energies[:warm],
                             forces[:warm], device=device)
    common.sync(device)
    t0 = time.perf_counter()
    rows = featurize_dataset_device(basis, geometries, energies, forces,
                                    device=device)
    common.sync(device)
    return rows, time.perf_counter() - t0


def run(n_configs: int = N_CONFIGS, device=None, commit: str = None,
        keep: dict = None) -> dict:
    """The throughput of ``n_configs`` configurations; ``keep``, where
    given, receives the rows."""
    device = common.resolve_device(device)
    geometries, energies, forces = build_dataset(n_configs)
    print(f"{n_configs} configs x {len(geometries[0])} atoms, platform = "
          f"{common.platform(device)}", flush=True)
    rows, seconds = featurize_timed(demo_basis(), geometries, energies,
                                    forces, WARM_CONFIGS, device)
    x_e, _, x_f, _ = rows
    result = {"metric": "device featurization of 128-atom bcc W cells, "
                        "s per configuration",
              "platform": common.platform(device),
              "n_configs": n_configs,
              "n_atoms_per_config": len(geometries[0]),
              "x_e_shape": list(x_e.shape), "x_f_shape": list(x_f.shape),
              "featurize_s": seconds,
              "featurize_ms_per_config": 1e3 * seconds / n_configs}
    print(f"x_e {x_e.shape}, x_f {x_f.shape}")
    print(f"{seconds:.2f} s total = {1e3 * seconds / n_configs:.1f} "
          "ms/config")
    if keep is not None:
        keep["rows"] = rows
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
    path = common.write_artifact(result, args.out_dir,
                                 "featurize_throughput.json")
    print(json.dumps(result))
    print(f"wrote {path}")
    return result


if __name__ == "__main__":
    main()
