"""
The models the port runs through the reference's general force path,
in float64 on the CPU, from the same numpy inputs:

- against the host oracle ``UFCalculator``: the unary 2+3-body and the
  binary 2-body model files (as test_matches_host_calculator and
  test_matches_host_binary), and a unary model whose 3-body cutoff
  (4 A) passes its 2-body cutoff (3 A), where the engine builds the
  3-body list on its own and runs the fused kernels on separate gathers;
- against the JAX engine, positions within 1e-9 A: NVE on
  ``benchmarks_data/model_2.json`` (2-body W) and on
  ``tests/data/model_binary.json`` (Ne/Xe), SCR NPT at T = 0 on
  ``model_2.json`` (cells within 1e-9), each port system built through
  ``FactorizedPotential.from_jax_params`` of the JAX engine's tables;
- the fused routes against each other ("shared" and "separate", 1e-10),
  binary MD on the port alone, the option that still raises, and the md
  command on the 2-body model.

JAX is run once, in one module fixture.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uf3_tpu.data import elements
from uf3_tpu.data.atoms import Atoms, bulk
from uf3_tpu.data.composition import ChemicalSystem
from uf3_tpu.forcefield import units
from uf3_tpu.forcefield.calculator import UFCalculator
from uf3_tpu.forcefield.md import MDSystem as JaxMDSystem
from uf3_tpu.ops import neighbors as jnb
from uf3_tpu.ops import potential as jpot
from uf3_tpu.regression import least_squares as ls
from uf3_tpu.representation.basis import BSplineBasis
from uf3_tpu_torch import io
from uf3_tpu_torch.__main__ import main
from uf3_tpu_torch.data import composition as t_comp
from uf3_tpu_torch.forcefield.md import MDSystem
from uf3_tpu_torch.ops import factorized as fz
from uf3_tpu_torch.ops.potential import stress_voigt
from uf3_tpu_torch.representation import basis as t_basis

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_2 = os.path.join(REPO, "benchmarks_data", "model_2.json")
MODEL_23 = os.path.join(REPO, "benchmarks_data", "model_2and3.json")
UNARY = os.path.join(REPO, "tests", "data", "model_unary.json")
BINARY = os.path.join(REPO, "tests", "data", "model_binary.json")
NPT = dict(n_steps=48, dt_fs=2.0, temperature=0.0, pressure=0.05,
           tau_p_fs=40.0, compressibility=0.2)
POS_TOL = 1e-9
# the model of a 3-body cutoff beyond the 2-body cutoff: pair r 1.5-3.0
# A in 8 intervals, trio legs up to (4, 4, 8) A in (6, 6, 12)
LONG_TRIO = dict(r_min_map={("W", "W"): 1.5},
                 r_max_map={("W", "W"): 3.0, ("W", "W", "W"): [4.0, 4.0, 8.0]},
                 resolution_map={("W", "W"): 8, ("W", "W", "W"): [6, 6, 12]})


def long_trio_models():
    """The unary W model whose 3-body cutoff passes its 2-body cutoff,
    coefficients from RandomState(0) at scale 0.05: (JAX, port)."""
    basis = BSplineBasis(ChemicalSystem(["W"], degree=3), **LONG_TRIO)
    model = ls.WeightedLinearModel(basis)
    model.coefficients = np.random.RandomState(0).normal(
        scale=0.05, size=sum(basis.partition_sizes))
    port = t_basis.BSplineBasis(t_comp.ChemicalSystem(["W"], degree=3),
                                **LONG_TRIO)
    return model, io.FittedModel(port, model.coefficients.copy())


def _w(reps, rattle=0.05, seed=3):
    geom = bulk("W", "bcc", a=3.1652) * reps
    geom.rattle(rattle, seed=seed)
    return geom


def _ne_xe(reps=3, a=5.4, seed=3):
    rng = np.random.RandomState(seed)
    base = bulk("Ne", "fcc", a=a) * reps
    numbers = base.get_atomic_numbers()
    numbers[rng.rand(len(numbers)) > 0.5] = 54
    return Atoms(numbers=numbers, positions=base.positions, cell=base.cell,
                 pbc=True)


def _velocities(geom, temperature, seed=0):
    masses = elements.atomic_masses[geom.get_atomic_numbers()][:, None]
    v = np.random.RandomState(seed).normal(
        0.0, 1.0, (len(geom), 3)) * np.sqrt(units.kB * temperature / masses)
    return v - v.mean(axis=0)


def _snap(state):
    return dict(positions=np.array(state.positions),
                velocities=np.array(state.velocities),
                forces=np.array(state.forces), energy=float(state.energy),
                cell=np.array(state.cell))


def _port(jax_system, geom, **kw):
    """The port's engine on the JAX engine's tables."""
    port = fz.FactorizedPotential.from_jax_params(jax_system.params,
                                                  jax_system.static)
    return MDSystem(port, geom, dtype=torch.float64, device="cpu", **kw)


@pytest.fixture(scope="module")
def ref():
    """Every JAX and host-oracle result the tests read, as numpy."""
    out = {}
    model_2 = ls.WeightedLinearModel.from_json(MODEL_2)
    geom = _w(4)
    system = JaxMDSystem(model_2, geom, dtype=jnp.float64)
    v0 = _velocities(geom, 600.0)
    out["nve_2"] = dict(geom=geom, v0=v0, system=system, run=_snap(
        system.run(system.init_state(velocities=v0), n_steps=20, dt_fs=2.0)))
    geom = _w(3)
    system = JaxMDSystem(model_2, geom, dtype=jnp.float64, rebuild_every=12)
    v0 = _velocities(geom, 600.0, seed=1)
    st, cells = system.npt_run(system.init_state(velocities=v0), **NPT)
    out["npt_2"] = dict(geom=geom, v0=v0, system=system, run=_snap(st),
                        cells=[np.array(c) for c in cells])
    geom = _ne_xe()
    system = JaxMDSystem(ls.WeightedLinearModel.from_json(BINARY), geom,
                         dtype=jnp.float64)
    v0 = _velocities(geom, 50.0, seed=2)
    out["nve_binary"] = dict(geom=geom, v0=v0, system=system, run=_snap(
        system.run(system.init_state(velocities=v0), n_steps=20, dt_fs=2.0)))
    # the 3-body cutoff beyond the 2-body cutoff: the host oracle, and the
    # JAX factorized path on lists whose 3-body part has reverse slots
    model, _ = long_trio_models()
    geom = bulk("W", "bcc", a=3.1652) * 4
    geom.rattle(0.05, seed=1)
    calc = UFCalculator(model)
    params, static = jpot.build_potential(model, dtype=jnp.float64)
    pos, cell = jnp.asarray(geom.positions), jnp.asarray(geom.cell)
    nbr2 = jnb.build_neighbor_list(pos, cell, geom.pbc, 3.5, 24)
    nbr3 = jnb.build_neighbor_list(pos, cell, geom.pbc, 4.5, 40,
                                   with_rev=True)
    species = params.z_to_species[jnp.asarray(geom.numbers)]
    jax_out = jpot.compute_energy_forces(params, species, pos, cell, nbr2,
                                         nbr3, static=static)
    out["long_trio"] = dict(
        geom=geom, params=params, static=static,
        energy=calc.get_potential_energy(geom), forces=calc.get_forces(geom),
        jax=[np.asarray(x) for x in jax_out])
    # the unary and binary model files on the host oracle
    for name, path, reps in (("unary", UNARY, None), ("binary", BINARY, 4)):
        model = ls.WeightedLinearModel.from_json(path)
        if reps is None:
            geom = bulk("W", "bcc", a=3.16) * 4
            geom.rattle(0.05, seed=3)
        else:
            geom = _ne_xe(reps, a=5.2, seed=0)
            geom.rattle(0.08, seed=1)
        calc = UFCalculator(model)
        out[name] = dict(geom=geom, model=model,
                         energy=calc.get_potential_energy(geom),
                         forces=calc.get_forces(geom),
                         stress=calc.get_stress(geom) if reps is None
                         else None)
    return out


def _same(ref_snap, state, cell, tol=POS_TOL):
    d = ref_snap["positions"] - state.positions.numpy()
    frac = d @ np.linalg.inv(cell)
    assert np.abs((frac - np.round(frac)) @ cell).max() < tol
    assert np.abs(ref_snap["velocities"] - state.velocities.numpy()).max() \
        < tol
    assert np.abs(ref_snap["forces"] - state.forces.numpy()).max() < tol
    assert abs(ref_snap["energy"] - float(state.energy)) < tol


# -- the host oracle ------------------------------------------------------------
# The fused routes rebuild each closed-form leg's knots as u0 + k h from
# its first gap, while the model files' knots are rounded to 1e-10 A:
# they sit up to 1.4e-9 eV/A (forces) and 1e-9 relative (energy) from the
# oracle, where the factorized path agrees to 1e-12.
FUSED_FORCE_TOL, FUSED_ENERGY_RTOL = 5e-9, 1e-9


@pytest.mark.parametrize("name", ["unary", "binary"])
def test_matches_host_calculator(ref, name):
    """The factorized path on the JAX tables against UFCalculator
    (energy 1e-9 eV, forces 1e-10 eV/A, the unary model's analytic
    stress against the oracle's numerical one 1e-6 eV/A^3), and the
    engine's entry state by the model's own route: the shared gather of
    the fused kernels for the unary model, the factorized path for the
    binary one."""
    r = ref[name]
    geom = r["geom"]
    port = MDSystem(UNARY if name == "unary" else BINARY, geom,
                    dtype=torch.float64, device="cpu")
    fused = port.potential.trio is not None
    assert fused == (name == "unary")
    state = port.init_state()
    params, static = jpot.build_potential(r["model"], dtype=jnp.float64)
    tables = MDSystem(fz.FactorizedPotential.from_jax_params(params, static),
                      geom, dtype=torch.float64, device="cpu")
    energy, forces, virial = tables.energy_forces_virial(
        state.positions, state.nbr2, state.nbr3)
    assert abs(float(energy) - r["energy"]) < 1e-9
    assert np.abs(forces.numpy() - r["forces"]).max() < 1e-10
    if r["stress"] is not None:
        stress = stress_voigt(virial, geom.get_volume()).numpy()
        assert np.abs(stress - r["stress"]).max() < 1e-6
        assert np.abs(port.stress(state).numpy() - r["stress"]).max() < 1e-6
    e_tol = FUSED_ENERGY_RTOL * abs(r["energy"]) if fused else 1e-9
    f_tol = FUSED_FORCE_TOL if fused else 1e-10
    assert abs(float(state.energy) - r["energy"]) < e_tol
    assert np.abs(state.forces.numpy() - r["forces"]).max() < f_tol


def test_long_3body_cutoff_matches_host_calculator(ref):
    """r_cut_3b (4 A) > r_cut_2b (3 A): the engine builds the 3-body
    list on its own, with reverse slots, and runs the pair force and the
    trio twin on separate gathers.  Against UFCalculator and against the
    JAX factorized path on lists with reverse slots, 1e-9.

    The JAX engine fails this comparison by 2.32 eV/A: its separately
    built 3-body list has no reverse slots (``_build_one``'s
    ``with_rev=False``, uf3_tpu/forcefield/md.py:261,291-295), so its
    neighbor terms are gathered from the wrong rows.  It is not run
    here.  The engine's fused route sits 9.8e-10 eV/A and 2.8e-8 eV
    from the oracle here (the closed-form legs, above), the factorized
    path 1e-13."""
    r = ref["long_trio"]
    geom = r["geom"]
    _, model = long_trio_models()
    port = MDSystem(model, geom, dtype=torch.float64, device="cpu")
    assert port.separate_3b and not port.two_tier
    state = port.init_state()
    nbr3 = state.nbr3
    assert nbr3.sel is None
    idx, rev, mask = nbr3.idx.numpy(), nbr3.rev.numpy(), nbr3.mask.numpy()
    a, s = np.nonzero(mask)
    assert np.array_equal(idx[idx[a, s], rev[a, s]], a)
    assert int(mask.sum(1).min()) > 14   # beyond the 2-body list's 8
    tables = MDSystem(fz.FactorizedPotential.from_jax_params(
        r["params"], r["static"]), geom, dtype=torch.float64, device="cpu")
    e_f, f_f, v_f = tables.energy_forces_virial(state.positions, state.nbr2,
                                                nbr3)
    assert abs(float(e_f) - r["energy"]) < 1e-9
    assert np.abs(f_f.numpy() - r["forces"]).max() < 1e-9
    assert abs(float(state.energy) - r["energy"]) \
        < FUSED_ENERGY_RTOL * abs(r["energy"])
    assert np.abs(state.forces.numpy() - r["forces"]).max() < FUSED_FORCE_TOL
    e_j, f_j, v_j = r["jax"]
    assert abs(float(e_f) - float(e_j)) < 1e-9
    assert np.abs(f_f.numpy() - f_j).max() < 1e-9
    assert np.abs(v_f.numpy() - v_j).max() < 1e-9
    assert np.abs(r["forces"]).max() > 1.0
    # and it runs: after 24 steps (a rebuild at 20) the carried forces
    # equal the factorized path's on the state's lists.  (Its random pair
    # coefficients do not vanish at the 3 A cutoff, so the energy jumps
    # as pairs cross it: no drift gate.)
    st = port.run(state, n_steps=24, dt_fs=1.0)
    assert not port.overflowed(st)
    _, f_f, _ = tables.energy_forces_virial(st.positions, st.nbr2, st.nbr3)
    assert torch.max(torch.abs(st.forces - f_f)) < FUSED_FORCE_TOL


# -- MD against the JAX engine --------------------------------------------------
@pytest.mark.parametrize("name", ["nve_2", "nve_binary"])
def test_nve_matches_jax(ref, name):
    """20 NVE steps of 2 fs, one launch: the 2-body W model on 128 atoms
    (the minimum-image builder), the binary Ne/Xe model on 108 atoms
    (the images builder), both by the factorized path."""
    r = ref[name]
    port = _port(r["system"], r["geom"])
    assert port.degree == 2 and port.capacity_3b == 0
    state = port.init_state(velocities=r["v0"])
    assert state.nbr3 is None
    st = port.run(state, n_steps=20, dt_fs=2.0)
    _same(r["run"], st, r["geom"].cell)
    assert not port.overflowed(st)


def test_scr_npt_matches_jax(ref):
    """SCR NPT at T = 0 on the 2-body model (deterministic): positions
    and the cell after each launch within 1e-9."""
    r = ref["npt_2"]
    port = _port(r["system"], r["geom"], rebuild_every=12)
    state, cells = port.npt_run(port.init_state(velocities=r["v0"]), **NPT)
    assert len(cells) == len(r["cells"]) == 4
    for a, b in zip(cells, r["cells"]):
        assert np.abs(a - b).max() < 1e-9
    cell = state.cell.numpy()
    assert np.abs(cell / r["geom"].cell[0, 0] - np.eye(3)).max() > 1e-3
    _same(r["run"], state, cell)


def test_binary_md_runs():
    """Multi-species MD on the port alone (twin of test_binary_md_runs):
    20 NVE steps from 50 K stay finite and within 1e-3 eV/atom."""
    geom = _ne_xe()
    port = MDSystem(BINARY, geom, dtype=torch.float64, device="cpu",
                    rebuild_every=5)
    assert port.potential.trio is None
    state = port.init_state(temperature=50.0, seed=0)
    e0 = float(state.energy) + port.kinetic_energy(state)
    state = port.run(state, n_steps=20, dt_fs=1.0)
    e1 = float(state.energy) + port.kinetic_energy(state)
    assert np.isfinite(e1)
    assert abs(e1 - e0) / len(geom) < 1e-3


def test_separate_route_matches_shared():
    """fused="separate" (the pair force and the trio kernel's twin on
    their own gathers) against the shared gather, on the bench model:
    entry forces and virial, and 12 NVE steps, within 1e-10."""
    geom = _w(3)
    v0 = _velocities(geom, 600.0)
    out = []
    for fused in ("shared", "separate"):
        port = MDSystem(MODEL_23, geom, dtype=torch.float64, device="cpu",
                        rebuild_every=6, fused=fused)
        state = port.init_state(velocities=v0)
        virial = port.energy_forces(state.positions, state.nbr2, state.nbr3,
                                    with_virial=True)[2]
        out.append((state, virial, port.run(state, n_steps=12, dt_fs=2.0)))
    (s0, v_s, s12), (t0, v_t, t12) = out
    for a, b in ((s0.forces, t0.forces), (v_s, v_t),
                 (s12.positions, t12.positions), (s12.forces, t12.forces)):
        assert torch.max(torch.abs(a - b)) < 1e-10
    assert abs(float(s12.energy) - float(t12.energy)) < 1e-10


# -- what raises ----------------------------------------------------------------
def test_respa_and_unported_options_raise():
    """r-RESPA on a 2-body model, or with the 3-body cutoff beyond the
    2-body one, raises the reference's ValueError; the engine options
    ported since construct and run: the triangle-lane trio layout (to
    the full lanes' forces and energy, and ignored on the 2-body model,
    as in the reference), static_rebuild and eager_refilter=False."""
    geom = _w(3)
    with pytest.raises(ValueError, match="requires a 2\\+3-body model"):
        MDSystem(MODEL_2, geom, dtype=torch.float64, device="cpu",
                 n_respa=2)
    with pytest.raises(ValueError, match="r_cut_3b <= r_cut_2b"):
        MDSystem(long_trio_models()[1], geom, dtype=torch.float64,
                 device="cpu", n_respa=2)
    with pytest.raises(ValueError, match="closed form"):
        MDSystem(fz.FactorizedPotential.from_model(io.load_model(MODEL_23)),
                 geom, dtype=torch.float64, device="cpu", n_respa=2)
    with pytest.raises(ValueError, match="fused"):
        MDSystem(MODEL_23, geom, device="cpu", fused="fused")
    out = []
    for triangle in (True, False):
        port = MDSystem(MODEL_23, geom, dtype=torch.float64, device="cpu",
                        trio_triangle=triangle)
        state = port.run(port.init_state(temperature=600.0, seed=2),
                         n_steps=6, dt_fs=2.0)
        out.append((port.triangle, state))
    (tri_on, tri), (tri_off, full) = out
    assert tri_on and not tri_off
    assert torch.max(torch.abs(tri.forces - full.forces)) < 1e-10
    assert abs(float(tri.energy) - float(full.energy)) < 1e-10
    two_body = MDSystem(MODEL_2, geom, dtype=torch.float64, device="cpu",
                        trio_triangle=True)
    assert not two_body.triangle
    for ported in (dict(static_rebuild=True),
                   dict(skin_2b=1.2, eager_refilter=False)):
        port = MDSystem(MODEL_23, geom, dtype=torch.float64, device="cpu",
                        **ported)
        assert port.static_rebuild or (port.two_tier
                                       and not port.eager_refilter)


def test_md_command_runs_the_2body_model(capsys):
    """``python -m uf3_tpu_torch md benchmarks_data/model_2.json``, on
    the CPU: bcc W of the model's element, as the reference command."""
    main(["md", MODEL_2, "--reps", "3", "--steps", "12", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "54 atoms of W"
    found = re.fullmatch(r"12 steps in \S+ s \((\S+) atom-steps/s\); "
                         r"T = (\S+) K, E = (\S+) eV", out[-1])
    assert found is not None, out[-1]
    assert all(np.isfinite(float(x)) for x in found.groups())
