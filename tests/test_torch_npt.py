"""
The melting protocol's path of the port against the JAX engine, in
float64 on the CPU, from the same numpy inputs: the analytic virial
(the pair rows' 1/2 sum w d d plus the 3-body virial from the trio
partials) and the stress, Nose-Hoover on plain velocity Verlet and on
3-level r-RESPA, SCR and Berendsen NPT at T = 0 (where the Langevin and
SCR noise terms vanish and the trajectory is deterministic), and
capacity regrowth.  Pinned atoms: the Nose-Hoover step and the Berendsen
factor against a numpy hand computation of the masked kinetic energy
(the port's choice, ROADMAP.md section 3; the reference also counts the
pinned atoms).

Cells: bcc W 3^3 (54 atoms, periodic, the images builder), rattled, and
8 x 8 x 4 (512 atoms, the smallest box on the cell-list builder).  The
JAX results are computed once, in one module fixture
(``tests/conftest.py`` clears JAX's caches after each test).
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
from uf3_tpu.ops import pallas_trio as pt
from uf3_tpu.ops import potential as jpot
from uf3_tpu.regression import least_squares as ls
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops.potential import UF3Potential

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

MODEL = os.path.join("benchmarks_data", "model_2and3.json")
# rebuild cycles of 12 steps: the 36- and 48-step runs are whole
# cycles, and the JAX engine compiles one launch for each run
PLAIN = dict(rebuild_every=12)
RESPA3 = dict(n_respa=4, respa_mid=2, rebuild_every=12)
NH = dict(n_steps=36, dt_fs=2.0, thermostat="nose_hoover",
          temperature=600.0, tau_fs=50.0)
# T = 0: the SCR noise sqrt(2 kB T beta dt / (V tau_p)) and the Langevin
# noise are zero, the friction stays
NPT = dict(n_steps=48, dt_fs=2.0, temperature=0.0, pressure=0.05,
           tau_p_fs=40.0, compressibility=0.2)
VIRIAL_TOL = 1e-9
POS_TOL = 1e-8

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



def _geom(reps, rattle=0.05, seed=11):
    geom = bulk("W", "bcc", a=3.1652) * reps
    geom.rattle(rattle, seed=seed)
    return geom


def _velocities(n_atoms, temperature=1000.0, seed=0):
    rng = np.random.RandomState(seed)
    v = rng.normal(0.0, np.sqrt(units.kB * temperature / 183.84),
                   (n_atoms, 3))
    return v - v.mean(axis=0)


def _np(x):
    return np.array(x)


@pytest.fixture(scope="module")
def ref():
    """Every JAX result the tests read, as numpy."""
    model = ls.WeightedLinearModel.from_json(MODEL)
    out = {}
    for name, reps in (("512", (8, 8, 4)), ("54", (3, 3, 3))):
        system = JaxMDSystem(model, _geom(reps), dtype=jnp.float64,
                             **PLAIN)
        st = system.init_state()
        out[name] = dict(
            positions=_np(st.positions),
            virial=_np(system.energy_forces(st.positions, st.nbr2, st.nbr3,
                                            with_virial=True)[2]),
            oracle=_np(system.energy_forces_virial(st.positions, st.nbr2,
                                                   st.nbr3)[2]),
            stress=_np(system.stress(st)), cells=system._cells_2b)
    v0 = _velocities(54)
    # the last loop's system: the 54-atom cell
    st = system.run(system.init_state(velocities=v0), launch_chunks=3,
                    **NH)
    out["nh_plain"] = dict(positions=_np(st.positions), xi=float(st.xi))
    st, cells = system.npt_run(system.init_state(velocities=v0), **NPT)
    out["scr"] = dict(positions=_np(st.positions), cell=_np(st.cell),
                      cells=[_np(c) for c in cells])
    st, cells = system.npt_run(system.init_state(velocities=v0),
                               barostat="berendsen", **NPT)
    out["berendsen"] = dict(positions=_np(st.positions), cell=_np(st.cell),
                            cells=[_np(c) for c in cells])
    system = JaxMDSystem(model, _geom((3, 3, 3)), dtype=jnp.float64,
                         **RESPA3)
    st = system.run(system.init_state(velocities=v0), launch_chunks=3,
                    **NH)
    out["nh_respa3"] = dict(positions=_np(st.positions), xi=float(st.xi))
    out["v0"] = v0
    return out


def _same_positions(ref_positions, positions, cell):
    """Within POS_TOL modulo lattice translations of ``cell``."""
    d = ref_positions - positions
    frac = d @ np.linalg.inv(cell)
    return np.abs((frac - np.round(frac)) @ cell).max()


# -- virial and stress ------------------------------------------------------
@pytest.mark.parametrize("cell", ["54", "512"])
def test_virial_matches_jax(ref, cell):
    """The virial of energy_forces(with_virial=True) against the JAX
    engine's to 1e-9 eV.  Against the factorized oracle
    ``energy_forces_virial`` with the tolerance of the JAX engine's own
    test (tests/test_device_potential.py:624, atol 1e-9, rtol 1e-5):
    the JAX fused and factorized virials differ by ~3e-9 relative."""
    r = ref[cell]
    geom = _geom((3, 3, 3) if cell == "54" else (8, 8, 4))
    port = MDSystem(port_model(), geom, dtype=torch.float64, device="cpu")
    assert (port._cells_2b is None) == (r["cells"] is None)
    state = port.init_state()
    assert np.abs(state.positions.numpy() - r["positions"]).max() < 1e-12
    energy, forces, virial = port.energy_forces(
        state.positions, state.nbr2, state.nbr3, with_virial=True)
    virial = virial.numpy()
    assert np.abs(virial - r["virial"]).max() < VIRIAL_TOL
    assert np.allclose(virial, r["oracle"], atol=1e-9)
    # on the file's own knots the port's fused virial is the oracle's
    # (the JAX fused route's ~3e-9 relative was its closed-form legs:
    # ROADMAP.md section 3)
    own = MDSystem(MODEL, geom, dtype=torch.float64, device="cpu")
    virial_own = own.energy_forces(state.positions, state.nbr2, state.nbr3,
                                   with_virial=True)[2].numpy()
    assert np.abs(virial_own - r["oracle"]).max() < VIRIAL_TOL
    assert np.array_equal(virial, virial.T)
    assert np.abs(virial).max() > 1.0
    e0, f0, none = port.energy_forces(state.positions, state.nbr2,
                                      state.nbr3)
    assert none is None and float(e0) == float(energy)
    assert torch.equal(f0, forces)


def test_virial_is_the_strain_derivative():
    """W_ab = dE / d eps_ab under the homogeneous strain x -> x (1 +
    eps), cell -> cell (1 + eps): central differences of the port's own
    energy, h = 1e-5, to 1e-6 eV."""
    geom = _geom((3, 3, 3))
    port = MDSystem(MODEL, geom, dtype=torch.float64, device="cpu")
    state = port.init_state()
    _, _, virial = port.energy_forces(state.positions, state.nbr2,
                                      state.nbr3, with_virial=True)
    h = 1e-5

    def energy(eps):
        strain = torch.eye(3, dtype=torch.float64) + eps
        x, cell = state.positions @ strain, port.cell @ strain
        nbr2, nbr3 = port.build_lists(x, cell)
        return float(port.energy_forces(x, nbr2, nbr3, cell=cell)[0])

    for a in range(3):
        for b in range(a, 3):
            eps = torch.zeros((3, 3), dtype=torch.float64)
            eps[a, b] += 0.5 * h
            eps[b, a] += 0.5 * h
            fd = (energy(eps) - energy(-eps)) / (2.0 * h)
            assert abs(fd - float(virial[a, b])) < 1e-6, (a, b)


def test_stress_matches_jax(ref):
    port = MDSystem(port_model(), _geom((3, 3, 3)), dtype=torch.float64,
                    device="cpu")
    stress = port.stress(port.init_state()).numpy()
    assert stress.shape == (6,)
    assert np.abs(stress - ref["54"]["stress"]).max() < 1e-12
    assert np.abs(stress).max() > 1e-2


# -- Nose-Hoover --------------------------------------------------------------
@pytest.mark.parametrize("name, kw", [("nh_plain", PLAIN),
                                      ("nh_respa3", RESPA3)])
def test_nose_hoover_matches_jax(ref, name, kw):
    """36 steps of Nose-Hoover (600 K, tau 50 fs) from the same
    velocities: positions within 1e-8 A, xi within 1e-10."""
    geom = _geom((3, 3, 3))
    port = MDSystem(MODEL, geom, dtype=torch.float64, device="cpu", **kw)
    state = port.run(port.init_state(velocities=ref["v0"]), **NH)
    assert _same_positions(ref[name]["positions"], state.positions.numpy(),
                           geom.cell) < POS_TOL
    assert abs(float(state.xi) - ref[name]["xi"]) < 1e-10
    assert abs(ref[name]["xi"]) > 1e-4


def _pinned(n_atoms, temperature, seed=4):
    """Masses with the atoms of even index pinned (1e12), and every
    atom's velocities drawn at ``temperature``: the pinned atoms then
    carry kT/2 per degree of freedom at ~zero speed, as Langevin leaves
    them."""
    masses = np.full(n_atoms, 183.84)
    masses[::2] = 1e12
    rng = np.random.RandomState(seed)
    v = rng.normal(0.0, 1.0, (n_atoms, 3)) \
        * np.sqrt(units.kB * temperature / masses)[:, None]
    return masses, v


def test_nose_hoover_step_counts_mobile_atoms_only():
    """One Nose-Hoover step with half the atoms pinned against numpy:
    the kick, then xi += dt (2 K_mobile - dof kB T) / q with q = dof kB
    T tau^2, v *= exp(-xi dt).  The reference's sum over all atoms would
    give another xi."""
    geom = _geom((3, 3, 3))
    masses, v0 = _pinned(len(geom), 900.0)
    port = MDSystem(MODEL, geom, dtype=torch.float64, device="cpu",
                    masses=masses)
    assert port.n_mobile == 27 and port.dof == 81
    st0 = port.init_state(velocities=v0)
    st0 = st0._replace(xi=torch.tensor(0.3 / units.ps, dtype=torch.float64))
    st1 = port.run(st0, n_steps=1, dt_fs=2.0, thermostat="nose_hoover",
                   temperature=600.0, tau_fs=50.0)
    dt, m = 2.0 * units.fs, masses[:, None]
    v = v0 + 0.5 * dt * st0.forces.numpy() / m
    v = v + 0.5 * dt * st1.forces.numpy() / m
    mobile = masses < 1e9
    kt = 81 * units.kB * 600.0
    q = kt * (50.0 * units.fs) ** 2
    ke_mobile = 0.5 * np.sum(m[mobile] * v[mobile] ** 2)
    ke_all = 0.5 * np.sum(m * v ** 2)
    xi = float(st0.xi) + dt * (2.0 * ke_mobile - kt) / q
    xi_all = float(st0.xi) + dt * (2.0 * ke_all - kt) / q
    assert abs(float(st1.xi) - xi) < 1e-12 * abs(xi)
    assert abs(xi_all - xi) > 0.5 * abs(xi)
    assert np.abs(st1.velocities.numpy() - v * np.exp(-xi * dt)).max() \
        < 1e-14


def test_berendsen_factor_counts_mobile_atoms_only():
    """The Berendsen factor (1 - t / tau_p beta (P0 - P))^(1/3) with
    half the atoms pinned, P = -tr(sigma) / 3 + 2 K_mobile / (3 V),
    against numpy; the reference's unmasked K would give another."""
    geom = _geom((3, 3, 3))
    masses, v0 = _pinned(len(geom), 3000.0)
    port = MDSystem(MODEL, geom, dtype=torch.float64, device="cpu",
                    masses=masses)
    state = port.init_state(velocities=v0)
    scale = port._berendsen_scale(state, 40.0, 0.05, 40.0, 0.2)
    stress = port.stress(state).numpy()
    volume = geom.get_volume()
    m, mobile = masses[:, None], masses < 1e9
    ke_mobile = 0.5 * np.sum(m[mobile] * v0[mobile] ** 2)
    ke_all = 0.5 * np.sum(m * v0 ** 2)

    def factor(ke):
        p = -np.sum(stress[:3]) / 3.0 + 2.0 * ke / (3.0 * volume)
        return (1.0 - (40.0 / 40.0) * 0.2 * (0.05 - p)) ** (1.0 / 3.0)

    assert abs(scale - factor(ke_mobile)) < 1e-14
    assert abs(factor(ke_all) - factor(ke_mobile)) > 1e-4


# -- NPT ------------------------------------------------------------------------
@pytest.mark.parametrize("launch_chunks", [1, 4])
def test_scr_npt_matches_jax(ref, launch_chunks):
    """SCR NPT at T = 0 (P0 = 0.05 eV/A^3, tau_p 40 fs, beta 0.2): the
    trajectory is deterministic; positions and cells within 1e-9 of the
    JAX engine's four launches of one 12-step cycle.  launch_chunks
    only groups cycles: at 4 one launch runs them all and gives the
    last cell."""
    geom = _geom((3, 3, 3))
    port = MDSystem(MODEL, geom, dtype=torch.float64, device="cpu",
                    **PLAIN)
    state, cells = port.npt_run(port.init_state(velocities=ref["v0"]),
                                launch_chunks=launch_chunks, **NPT)
    r = ref["scr"]
    assert len(r["cells"]) == 4
    expected = r["cells"] if launch_chunks == 1 else r["cells"][3:]
    assert len(cells) == len(expected)
    for a, b in zip(cells, expected):
        assert np.abs(a - b).max() < 1e-9
    cell = state.cell.numpy()
    assert np.abs(cell - r["cell"]).max() < 1e-9
    assert _same_positions(r["positions"], state.positions.numpy(),
                           cell) < 1e-9
    moved = np.abs(cell / geom.cell[0, 0] - np.eye(3)).max()
    assert moved > 1e-3
    # isotropic: the cell stays a multiple of the entry cell
    assert np.abs(cell - cell[0, 0] / geom.cell[0, 0] * geom.cell).max() \
        < 1e-12


def test_berendsen_npt_matches_jax(ref):
    geom = _geom((3, 3, 3))
    port = MDSystem(MODEL, geom, dtype=torch.float64, device="cpu",
                    **PLAIN)
    state, cells = port.npt_run(port.init_state(velocities=ref["v0"]),
                                barostat="berendsen", **NPT)
    r = ref["berendsen"]
    assert len(cells) == len(r["cells"]) == 4  # a rescale per cycle
    for a, b in zip(cells, r["cells"]):
        assert np.abs(a - b).max() < 1e-9
    cell = state.cell.numpy()
    assert _same_positions(r["positions"], state.positions.numpy(),
                           cell) < 1e-9
    assert np.abs(cell / geom.cell[0, 0] - np.eye(3)).max() > 1e-3


# -- regrowth ---------------------------------------------------------------------
def _overflowing_state():
    """A system and a state whose next rebuild overflows: positions
    squeezed 0.78x about their center after init (twin of
    TestNPT._overflowing_state, tests/test_device_potential.py)."""
    port = MDSystem(MODEL, bulk("W", "bcc", a=3.1652) * 3,
                    dtype=torch.float64, device="cpu", rebuild_every=1,
                    skin=0.4)
    state = port.init_state(temperature=10.0, seed=3)
    center = torch.mean(state.positions, dim=0)
    return port, state._replace(
        positions=center + 0.78 * (state.positions - center))


def test_run_regrows_on_overflow():
    """on_overflow='regrow' reverts the launch that overflowed, grows
    the capacities and completes with whole lists: the final forces
    equal a fresh evaluation on lists built at the grown capacities
    (twin of test_run_regrows_on_overflow)."""
    port, state = _overflowing_state()
    with pytest.raises(RuntimeError, match="capacity exceeded"):
        port.run(state, n_steps=2, dt_fs=0.1)
    port, state = _overflowing_state()
    caps = (port.capacity_2b, port.capacity_3b)
    out = port.run(state, n_steps=2, dt_fs=0.1, on_overflow="regrow")
    assert port.capacity_2b > caps[0] and port.capacity_3b > caps[1]
    assert not port.overflowed(out)
    nbr2, nbr3 = port.build_lists(out.positions, cell=out.cell)
    assert not bool(nbr2.overflow | nbr3.overflow)
    _, f_ref, _ = port.energy_forces(out.positions, nbr2, nbr3,
                                     cell=out.cell)
    assert torch.max(torch.abs(out.forces - f_ref)) < 1e-9
    port, state = _overflowing_state()
    with pytest.raises(RuntimeError, match="after 0 regrows"):
        port.run(state, n_steps=2, dt_fs=0.1, on_overflow="regrow",
                 max_regrows=0)
