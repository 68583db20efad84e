"""
The triangle-lane layout of the trio pass (``trio_partials(...,
triangle=True)``, ``MDSystem(trio_triangle=True)``) against the JAX
engine's ``trio_forces_unrolled(triangle=True)`` and
``MDSystem(trio_triangle=True)`` (uf3_tpu/ops/pallas_trio.py,
uf3_tpu/forcefield/md.py), float64 on the CPU: the twins of
``test_triangle_kernel_exact`` and ``test_triangle_capacity_one_falls_back``
(tests/test_device_potential.py) and of the triangle case of
``test_center_weight_virial_partition`` (tests/test_fused_kernels.py),
then a plain-Verlet and a 3-level r-RESPA trajectory with the option on,
at the bounds of the engine twins in tests/test_torch_verlet.py.  The
kernel itself is held to the plain triangle version on the card in
tests/test_torch_kernels.py.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uf3_tpu.data.atoms import bulk
from uf3_tpu.forcefield import units
from uf3_tpu.forcefield.md import MDSystem as JaxMDSystem
from uf3_tpu.ops import neighbors as jnb
from uf3_tpu.ops import pallas_trio as pt
from uf3_tpu.ops import potential as jpot
from uf3_tpu.regression import least_squares as ls
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops import neighbors as tnb
from uf3_tpu_torch.ops import trio
from uf3_tpu_torch.ops.potential import UF3Potential

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

MODEL = os.path.join("benchmarks_data", "model_2and3.json")
RESPA3 = dict(n_respa=4, respa_mid=2, rebuild_every=8, capacity_2b=64,
              capacity_3b=20)
POS_TOL = ENERGY_TOL = 1e-8   # tests/test_torch_verlet.py
FORCE_TOL, VIRIAL_TOL = 1e-10, 1e-9


@functools.lru_cache(maxsize=None)
def port_model() -> UF3Potential:
    """The port's potential of MODEL through the weights converter from
    the JAX package's own pair and trio bundles (the same leg specs in
    both engines, as tests/test_torch_verlet.py)."""
    model = ls.WeightedLinearModel.from_json(MODEL)
    params, _ = jpot.build_potential(model, dtype=jnp.float64)
    bundle = pt.build_trio_pallas(model, dtype=jnp.float64)
    spec, coefficients = pt.build_pair_fast(model, dtype=jnp.float64)
    return UF3Potential.from_jax_arrays(
        bundle._replace(grid=np.asarray(bundle.grid)),
        (spec, np.asarray(coefficients)), np.asarray(params.offsets_1b),
        np.asarray(params.z_to_species), float(params.r_cut_2b),
        float(params.r_cut_3b))


@pytest.fixture(scope="module")
def model():
    return ls.WeightedLinearModel.from_json(MODEL)


@pytest.fixture(scope="module")
def w27(model):
    """bcc W 3^3 rattled 0.05 A (seed 17), the reference test's cell:
    the JAX system, its entry lists and trio bundle, and the port's
    system on the same positions."""
    geom = bulk("W", "bcc", a=3.1652) * 3
    geom.rattle(0.05, seed=17)
    system = JaxMDSystem(model, geom, dtype=jnp.float64)
    assert system.trio_bundle.symmetric
    state = system.init_state()
    port = MDSystem(port_model(), geom, dtype=torch.float64, device="cpu")
    return system, state, port, port.init_state()


def _jax_trio(system, state, nbr=None, **kw):
    tb = system.trio_bundle
    n3 = state.nbr3 if nbr is None else nbr
    return pt.trio_forces_unrolled(
        tb.grid, state.positions, system.cell, n3.idx, n3.shift, n3.mask,
        n3.rev, spec_l=tb.spec_l, spec_n=tb.spec_n, l_basis=tb.l_basis,
        n_basis=tb.n_basis, active_bc=tb.active_bc, window=tb.window, **kw)


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def test_triangle_kernel_exact(w27):
    """Twin of test_triangle_kernel_exact: the port's triangle lanes
    within 1e-10 (energy, forces) and 1e-9 (virial) of JAX's triangle
    lanes, and of the port's own full lanes."""
    system, state, port, pstate = w27
    e_j, f_j, v_j = _jax_trio(system, state, with_virial=True,
                              triangle=True)
    pot = port.potential
    assert pot.trio.symmetric
    out = {}
    for triangle in (True, False):
        out[triangle] = [x.numpy() for x in trio.trio_forces(
            pot, pstate.positions, port.cell, pstate.nbr3,
            with_virial=True, triangle=triangle)]
    e_t, f_t, v_t = out[True]
    assert _err(e_t, e_j) < FORCE_TOL
    assert _err(f_t, f_j) < FORCE_TOL
    assert _err(v_t, v_j) < VIRIAL_TOL
    for a, b, tol in zip(out[True], out[False],
                         (FORCE_TOL, FORCE_TOL, VIRIAL_TOL)):
        assert _err(a, b) < tol
    assert np.abs(f_j).max() > 1e-1 and np.abs(v_j).max() > 1.0


def test_triangle_capacity_one_falls_back(w27):
    """Twin of test_triangle_capacity_one_falls_back: one slot holds no
    m < n pair, so the triangle request falls back to full lanes: zero
    energy and finite forces, as JAX's."""
    system, state, port, pstate = w27
    n3 = state.nbr3
    one_j = jnb.NeighborList(
        idx=n3.idx[:, :1], shift=n3.shift[:, :1], mask=n3.mask[:, :1],
        rev=jnp.zeros_like(n3.rev[:, :1]), overflow=n3.overflow,
        reference_positions=n3.reference_positions,
        sel=None if n3.sel is None else n3.sel[:, :1])
    e_j, f_j = _jax_trio(system, state, nbr=one_j, triangle=True)
    p3 = pstate.nbr3
    one_t = p3._replace(idx=p3.idx[:, :1].contiguous(),
                        shift=p3.shift[:, :1].contiguous(),
                        mask=p3.mask[:, :1].contiguous(),
                        rev=torch.zeros_like(p3.rev[:, :1]), sel=None)
    e_t, f_t = trio.trio_forces(port.potential, pstate.positions, port.cell,
                                one_t, triangle=True)
    assert bool(torch.all(torch.isfinite(f_t)))
    assert float(torch.abs(e_t).max()) == 0.0
    assert np.allclose(np.asarray(e_j), 0.0)
    assert _err(f_t.numpy(), f_j) < FORCE_TOL


@pytest.mark.parametrize("triangle", [False, True])
def test_center_weight_virial_partition(w27, triangle):
    """Twin of test_center_weight_virial_partition (the halo seam): an
    ownership partition w + (1 - w) of the centers reproduces the
    unweighted energy and virial within 1e-10, in both lane layouts, and
    each part is JAX's weighted result."""
    system, state, port, pstate = w27
    pot = port.potential
    full = trio.trio_forces(pot, pstate.positions, port.cell, pstate.nbr3,
                            with_virial=True, triangle=triangle)
    w = np.random.RandomState(7).randint(0, 2, len(pstate.positions))
    parts = []
    for wi in (w, 1 - w):
        wt = torch.as_tensor(wi, dtype=torch.float64)
        part = trio.trio_forces(pot, pstate.positions, port.cell,
                                pstate.nbr3, with_virial=True,
                                center_weight=wt, triangle=triangle)
        e_j, _, v_j = _jax_trio(system, state, with_virial=True,
                                triangle=triangle,
                                center_weight=jnp.asarray(wi, jnp.float64))
        assert _err(part[0].numpy(), e_j) < FORCE_TOL
        assert _err(part[2].numpy(), v_j) < VIRIAL_TOL
        parts.append(part)
    v_sum = parts[0][2] + parts[1][2]
    e_sum = float(torch.sum(parts[0][0]) + torch.sum(parts[1][0]))
    assert float(torch.max(torch.abs(v_sum - full[2]))) < 1e-10
    assert abs(e_sum - float(torch.sum(full[0]))) < 1e-10


def test_triangle_needs_a_symmetric_grid(w27):
    """The triangle lanes compute the full lanes' function only on a
    grid symmetric in its first two legs: any other grid raises."""
    _, _, port, pstate = w27
    pot = port.potential
    grid = np.random.RandomState(3).normal(0.0, 0.05, pot.trio.grid.shape)
    skew = UF3Potential(pot.pair_spec, pot.pair_coefficients.numpy(),
                        pot.trio._replace(grid=grid, symmetric=False),
                        pot.offsets_1b.numpy(), pot.z_to_species.numpy(),
                        pot.r_cut_2b, pot.r_cut_3b).to(dtype=torch.float64)
    cache = tnb.list_cache(pstate.nbr3, port.cell, torch.float64)
    d = tnb.cached_displacements(pstate.positions, pstate.nbr3, cache)
    with pytest.raises(ValueError, match="symmetric"):
        trio.trio_partials(skew, d, cache.valid, triangle=True)


# -- trajectories with the option on ------------------------------------------
def _velocities(n_atoms, temperature=1000.0, seed=0):
    rng = np.random.RandomState(seed)
    v = rng.normal(0.0, np.sqrt(units.kB * temperature / 183.84),
                   (n_atoms, 3))
    return v - v.mean(axis=0)


def _same_trajectory(ref, state, geom):
    """Positions modulo lattice translations, velocities, forces and
    energy at the engine twins' bounds."""
    d = np.asarray(ref.positions) - state.positions.numpy()
    frac = d @ np.linalg.inv(geom.cell)
    d = (frac - np.round(frac)) @ geom.cell
    assert np.abs(d).max() < POS_TOL
    assert _err(ref.velocities, state.velocities.numpy()) < POS_TOL
    assert _err(ref.forces, state.forces.numpy()) < 1e-8
    assert abs(float(ref.energy) - float(state.energy)) < ENERGY_TOL


@pytest.mark.parametrize("reps, engine, n_steps", [
    (3, {}, 12), (4, RESPA3, 16)], ids=["plain_verlet_54", "respa3_128"])
def test_trajectory_with_triangle_matches_jax(model, reps, engine, n_steps):
    """NVE with trio_triangle=True in both engines: plain velocity Verlet
    at the engine's defaults on 54 atoms, and 3-level r-RESPA 4/2 on 128
    atoms; the port's run on full lanes lands on the same state."""
    geom = bulk("W", "bcc", a=3.1652) * reps
    geom.rattle(0.05, seed=3)
    v0 = _velocities(len(geom))
    jax_sys = JaxMDSystem(model, geom, dtype=jnp.float64,
                          trio_triangle=True, **engine)
    ref = jax_sys.run(jax_sys.init_state(velocities=v0), n_steps=n_steps,
                      dt_fs=2.0)
    runs = {}
    for triangle in (True, False):
        port = MDSystem(port_model(), geom, dtype=torch.float64,
                        device="cpu", trio_triangle=triangle, **engine)
        assert port.triangle is triangle
        runs[triangle] = port.run(port.init_state(velocities=v0),
                                  n_steps=n_steps, dt_fs=2.0)
    _same_trajectory(ref, runs[True], geom)
    for name in ("positions", "velocities", "forces"):
        assert torch.max(torch.abs(getattr(runs[True], name)
                                   - getattr(runs[False], name))) < 1e-10
    assert np.abs(np.asarray(ref.forces)).max() > 1e-1
