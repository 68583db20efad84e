"""
The port's MD engine (uf3_tpu_torch/forcefield/md.py) against the JAX
engine (uf3_tpu/forcefield/md.py) on the 1,024-atom rattled bcc W box,
float64, the bench skins, capacities and switch with a 12/3/6 r-RESPA
cadence: 36 NVE steps from the same numpy velocities must give the same
positions within 1e-8 A modulo lattice translations (the two engines
wrap at different rebuilds) and the same energy within 1e-8 eV.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import torch

from uf3_tpu.data.atoms import bulk
from uf3_tpu.forcefield import units
from uf3_tpu.forcefield.md import MDSystem as JaxMDSystem
from uf3_tpu.ops import pallas_trio as pt
from uf3_tpu.ops import potential as jpot
from uf3_tpu.regression import least_squares as ls
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops.potential import UF3Potential

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

MODEL = os.path.join("benchmarks_data", "model_2and3.json")
KW = dict(rebuild_every=12, skin=0.5, skin_2b=1.2, capacity_2b=72,
          capacity_3b=16, n_respa=6, respa_mid=3, respa_switch=(2.5, 3.5))

@functools.lru_cache(maxsize=None)
def port_model() -> UF3Potential:
    """The port's potential of MODEL through the weights converter from
    the JAX package's own pair and trio bundles, so that both engines run
    the same leg specs (``UF3Potential.from_json`` evaluates the file's
    own knots, where the JAX package rebuilds them from the first knot
    gap: ROADMAP.md section 3; tests/test_torch_fit.py holds it to the
    host oracle)."""
    model = ls.WeightedLinearModel.from_json(MODEL)
    params, _ = jpot.build_potential(model, dtype=jnp.float64)
    trio = pt.build_trio_pallas(model, dtype=jnp.float64)
    spec, coefficients = pt.build_pair_fast(model, dtype=jnp.float64)
    return UF3Potential.from_jax_arrays(
        trio._replace(grid=np.asarray(trio.grid)),
        (spec, np.asarray(coefficients)), np.asarray(params.offsets_1b),
        np.asarray(params.z_to_species), float(params.r_cut_2b),
        float(params.r_cut_3b))



def _geom():
    geom = bulk("W", "bcc", a=3.1652) * (8, 8, 8)
    geom.rattle(0.05, seed=1)
    return geom


def _velocities(n_atoms, temperature=300.0):
    rng = np.random.RandomState(0)
    mass = 183.84  # W, amu
    v = rng.normal(0.0, np.sqrt(units.kB * temperature / mass),
                   (n_atoms, 3))
    return v - v.mean(axis=0)


def test_nve_trajectory_matches_jax():
    geom = _geom()
    v0 = _velocities(len(geom))
    jax_sys = JaxMDSystem(ls.WeightedLinearModel.from_json(MODEL), geom,
                          dtype=jnp.float64, **KW)
    st_j = jax_sys.run(jax_sys.init_state(velocities=v0), n_steps=36,
                       dt_fs=2.0)
    port = MDSystem(port_model(), geom, dtype=torch.float64, device="cpu", **KW)
    st_0 = port.init_state(velocities=v0)
    st_t = port.run(st_0, n_steps=36, dt_fs=2.0)
    d = (np.asarray(st_j.positions) - st_t.positions.numpy()) \
        @ np.linalg.inv(geom.cell)
    d -= np.round(d)
    err = np.abs(d @ geom.cell).max()
    assert err < 1e-8, err
    assert abs(float(st_j.energy) - float(st_t.energy)) < 1e-8
    assert np.allclose(np.asarray(st_j.velocities), st_t.velocities.numpy(),
                       atol=1e-10, rtol=0)
    # the atoms moved, and the run passed a rebuild-cycle boundary
    assert np.abs(st_t.positions.numpy()
                  - st_0.positions.numpy()).max() > 1e-2
    assert not port.overflowed(st_t)
    assert abs(port.temperature(st_t) - jax_sys.temperature(st_j)) < 1e-6
