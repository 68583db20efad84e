"""
Multi-shard demo on a ``torch.distributed`` group: halo-exchange MD over
slabs and a sharded fit, with ``parallel/mesh.py``'s ``ShardMesh``.

1. Halo MD: bcc W (4, 4, 4 S) rattled 0.03 A, cut into S slabs along z
   (``parallel/halo.py``), 5 velocity-Verlet NVE steps of 0.5 fs from
   rest in float64; the collectives carry only the slab boundaries.
2. The same 5 steps on the single-device ``MDSystem``, and the energy
   difference.
3. A sharded fit: 8 rattled bcc W 2^3 cells with random labels,
   featurized on the device, the Gram matrix summed over the mesh's
   shards (``fit_sharded``), and the fit's per-atom energy RMSE.

The group is NCCL on the card and gloo with ``--cpu``.  Under a launcher
that sets ``WORLD_SIZE`` (e.g. ``torchrun``) each rank joins through the
environment, one card a rank; otherwise the process makes a group of
world size 1 through a file store in a temporary directory.  A rank may
hold several shards.

    python -m uf3_tpu_torch.examples.multichip_demo [--shards S] [--cpu]
"""

import argparse
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from uf3_tpu_torch.data.atoms import bulk
from uf3_tpu_torch.data.composition import ChemicalSystem
from uf3_tpu_torch.forcefield import units
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops.featurize import featurize_dataset_device
from uf3_tpu_torch.parallel import halo
from uf3_tpu_torch.parallel import mesh as pmesh
from uf3_tpu_torch.regression.least_squares import WeightedLinearModel
from uf3_tpu_torch.representation.basis import BSplineBasis

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODEL = os.path.join(REPO, "benchmarks_data", "model_2and3.json")
A0 = 3.1652
DT_FS = 0.5
N_STEPS = 5


def init_group(device: torch.device):
    """(the group, a directory to remove after it or None): through the
    environment under a launcher, else a world of one through a file
    store."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return dist.group.WORLD, None
    tmp = tempfile.mkdtemp()
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'store')}",
        rank=0, world_size=1)
    return dist.group.WORLD, tmp


def halo_md(mesh, device):
    """5 NVE steps on the slabs and on the single device, float64:
    (E_halo, E_single) in eV."""
    n_shards = mesh.n_shards
    geom = bulk("W", "bcc", a=A0) * (4, 4, 4 * n_shards)
    geom.rattle(0.03, seed=0)
    print(f"{len(geom)} atoms in {n_shards} slabs")
    system = MDSystem(MODEL, geom, dtype=torch.float64, device=device)
    dec = halo.decompose(
        geom.get_positions(), geom.get_cell(), n_shards=n_shards,
        r_cut_2b=system.r_cut_2b, r_cut_3b=system.r_cut_3b,
        skin=system.skin, capacity_2b=system.capacity_2b,
        capacity_3b=system.capacity_3b, masses=geom.get_masses(),
        device=mesh.device)
    chunk, shard = halo.halo_md_step_factory(system, mesh, n_steps=N_STEPS)
    local = shard(dec)
    _, _, _, energy, stale = chunk(local, local.x_own,
                                   torch.zeros_like(local.x_own),
                                   DT_FS * units.fs)
    if bool(stale):
        raise RuntimeError("halo MD outran its skin in 5 steps")
    e_halo = float(energy)
    print(f"halo MD: {N_STEPS} NVE steps, E = {e_halo:.6f} eV "
          "(collectives carry only the slab boundaries)")
    state = system.init_state()
    state = system.run(state, n_steps=N_STEPS, dt_fs=DT_FS)
    e_single = float(state.energy)
    print(f"single-device E after the same steps: {e_single:.6f} eV "
          f"(diff {abs(e_single - e_halo):.2e})")
    return e_halo, e_single


def sharded_fit(mesh, device):
    """The fit of 8 rattled cells over the mesh: the per-atom energy
    RMSE in eV."""
    basis = BSplineBasis(
        ChemicalSystem(["W"], degree=3),
        r_min_map={("W", "W"): 1.5, ("W", "W", "W"): [1.5, 1.5, 1.5]},
        r_max_map={("W", "W"): 5.5, ("W", "W", "W"): [3.5, 3.5, 7.0]},
        resolution_map={("W", "W"): 15, ("W", "W", "W"): [4, 4, 8]})
    rng = np.random.RandomState(0)
    geometries, energies, forces = [], [], []
    for i in range(8):
        g = bulk("W", "bcc", a=A0) * 2
        g.rattle(0.04, seed=i)
        geometries.append(g)
        energies.append(-11.0 * len(g) + rng.normal() * 0.2)
        forces.append(rng.normal(size=(len(g), 3)) * 0.3)
    x_e, y_e, x_f, y_f = featurize_dataset_device(
        basis, geometries, energies, forces, device=device)
    model = WeightedLinearModel(basis, device=device, r2=1e-6, c2=1e-6,
                                r3=1e-6, c3=1e-6)
    pmesh.fit_sharded(model, x_e, y_e, x_f, y_f, weight=0.5, mesh=mesh)
    rmse = float(np.sqrt(np.mean((x_e @ model.coefficients - y_e) ** 2)))
    print(f"sharded fit: {len(geometries)} configs, per-atom-energy RMSE "
          f"{rmse * 1e3:.2f} meV (Gram psum over the mesh)")
    return rmse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU over gloo (default: the CUDA card "
                    "over NCCL)")
    args = ap.parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --cpu to run on the "
                               "CPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    group, tmp = init_group(device)
    try:
        mesh = pmesh.make_mesh(args.shards, group, device=device)
        print(f"mesh: {mesh} on {mesh.device}")
        e_halo, e_single = halo_md(mesh, device)
        rmse = sharded_fit(mesh, device)
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp)
    return {"e_halo": e_halo, "e_single": e_single, "rmse": rmse}


if __name__ == "__main__":
    main()
