"""
The port's ``UFCalculator`` (``uf3_tpu_torch/forcefield/calculator.py``)
and what runs on it, in float64 on the CPU, against the JAX package's
host calculator and drivers on the same inputs, with the reference's
literal values kept:

- the twins of ``tests/test_calculator.py``: the LJ dimer as a cluster
  and in a skewed 3 A cell, the trimer, ``test_unary_pbc``, the binary
  dimer, forces against finite differences, the dimer's relaxation;
- ``model_2and3.json`` on rattled bcc W 3^3 (the trio kernel's plain
  version), stress included; a cluster whose first list overflows and a
  compressed cell the cached system's capacity no longer holds: both
  regrow, neither truncates;
- ``batched_energy_and_forces`` / ``batch_relax`` and ``relax_with_cell``;
- the twins of ``tests/test_properties.py``: elastic constants, phonons,
  the symmetry-reduced force constants, the fcc path, the symmetry
  toolkit's op counts and lattice detection.

Tolerances: energy 1e-9 relative on the fused routes (their closed-form
legs rebuild the knots as u0 + k h, ~1e-9 relative from the host
calculator's, ROADMAP.md section 3), 1e-10 on the factorized path;
forces 5e-9 eV/A; stress 1e-8 eV/A^3 (the port's analytic virial
against the reference's central differences); elastic constants 1e-3
GPa; phonon frequencies 1e-6 THz.  Models built in code reach the port
as JSON.
"""

import os

import numpy as np
import pytest
import torch

from uf3_tpu.data.atoms import Atoms as JAtoms
from uf3_tpu.data.atoms import bulk as jbulk
from uf3_tpu.data import symmetry as j_sym
from uf3_tpu.data.composition import ChemicalSystem
from uf3_tpu.forcefield import batch as j_batch
from uf3_tpu.forcefield import optimize as j_opt
from uf3_tpu.forcefield.calculator import UFCalculator as JCalc
from uf3_tpu.forcefield.properties import elastic as j_elastic
from uf3_tpu.forcefield.properties import phonon as j_phonon
from uf3_tpu.regression import least_squares as ls
from uf3_tpu.representation import splines as sp
from uf3_tpu.representation.basis import BSplineBasis
from uf3_tpu_torch.data import atoms as t_atoms
from uf3_tpu_torch.data import symmetry as t_sym
from uf3_tpu_torch.forcefield import batch as t_batch
from uf3_tpu_torch.forcefield import optimize as t_opt
from uf3_tpu_torch.forcefield.calculator import UFCalculator
from uf3_tpu_torch.forcefield.properties import elastic as t_elastic
from uf3_tpu_torch.forcefield.properties import phonon as t_phonon

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNARY = os.path.join(REPO, "tests", "data", "model_unary.json")
BINARY = os.path.join(REPO, "tests", "data", "model_binary.json")
MODEL_23 = os.path.join(REPO, "benchmarks_data", "model_2and3.json")
E_FUSED, E_FACTORIZED = 1e-9, 1e-10   # relative
F_TOL, S_TOL = 5e-9, 1e-8             # eV/A, eV/A^3
C_TOL, NU_TOL = 1e-3, 1e-6            # GPa, THz


def _port(geom: JAtoms) -> t_atoms.Atoms:
    """The port's Atoms of a JAX package Atoms."""
    return t_atoms.Atoms(geom.numbers, geom.positions, geom.cell, geom.pbc,
                         info=geom.info, arrays=geom.arrays)


def _calcs(path):
    return (JCalc(ls.WeightedLinearModel.from_json(path)),
            UFCalculator(path, device="cpu"))


@pytest.fixture(scope="module")
def calcs():
    return {name: _calcs(path) for name, path in
            (("unary", UNARY), ("binary", BINARY), ("w23", MODEL_23))}


@pytest.fixture(scope="module")
def lj(tmp_path_factory):
    """The reference's LJ-fitted W dimer model (tests/test_calculator.py
    :12-50), and its JSON for the port."""
    config = BSplineBasis(ChemicalSystem(["W"]),
                          r_min_map={("W", "W"): 2.0},
                          r_max_map={("W", "W"): 6.0},
                          resolution_map={("W", "W"): 20},
                          knot_strategy="lammps")
    model = ls.WeightedLinearModel(bspline_config=config)
    pair = config.interactions_map[2][0]
    x = np.linspace(2.0, 6.0, 1000)
    y = 4 * 0.87 * ((2.5 / x) ** 12 - (2.5 / x) ** 6)
    model.coefficients = np.insert(
        sp.fit_spline_1d(x, y, config.knots_map[pair]), 0, 0)
    path = str(tmp_path_factory.mktemp("lj") / "lj.json")
    model.to_json(path)
    return JCalc(model), UFCalculator(path, device="cpu")


def _factorized(calc: UFCalculator) -> bool:
    pot = calc.potential
    return pot.trio is None and pot.trio_multi is None


def _same(jcalc, calc, geom, stress=False):
    """Energy (both conventions), forces and, with ``stress``, the
    stress of ``geom`` on both calculators; returns the port's."""
    ours = _port(geom)
    e_tol = E_FACTORIZED if _factorized(calc) else E_FUSED
    energy = calc.get_potential_energy(ours)
    ref = jcalc.get_potential_energy(geom)
    assert abs(energy - ref) <= e_tol * abs(ref), (energy, ref)
    fc = calc.get_potential_energy(ours, force_consistent=True)
    ref_fc = jcalc.get_potential_energy(geom, force_consistent=True)
    # the same absolute offset without the 1-body terms
    assert abs(fc - ref_fc) <= e_tol * abs(ref)
    forces = calc.get_forces(ours)
    assert forces.shape == (len(geom), 3)
    assert np.abs(forces - jcalc.get_forces(geom)).max() <= F_TOL
    if stress:
        s = calc.get_stress(ours)
        assert s.shape == (6,)
        assert np.abs(s - jcalc.get_stress(geom)).max() <= S_TOL
    return energy, forces


def test_unary_dimer_lj_fit(lj):
    jcalc, calc = lj
    assert len(calc.pair_potentials) == 1
    assert calc.degree == 2 and calc.r_cut == 6.0 and _factorized(calc)
    geom = JAtoms("W2", positions=[[0, 0, 0], [1.5, 1.5, 1.5]], pbc=False)
    energy, _ = _same(jcalc, calc, geom)
    assert np.isclose(energy, -1.21578)
    ours = _port(geom)
    ours.calc = calc
    assert np.allclose(ours.get_forces(),
                       [[-3.96244881, -3.96244881, -3.96244881],
                        [3.96244881, 3.96244881, 3.96244881]])
    # the same dimer in a skewed cell narrower than the cutoff; its
    # self-images sit at the cutoff (6 A), where this spline does not
    # vanish, so the reference's finite-difference stress is not
    # compared
    geom.pbc = np.array([True, True, True])
    geom.set_cell([[3, 0, 0], [3, 5, 0], [0, 0, 3]])
    energy, forces = _same(jcalc, calc, geom)
    assert np.isclose(energy, -15.33335)
    assert np.allclose(forces, [[0, -17.3656864, 0], [0, 17.3656864, 0]])


def test_unary_trimer(calcs):
    geom = JAtoms("W3", positions=[[0, 0, 0], [2, 0, 0], [0, 3, 0]],
                  pbc=False)
    energy, forces = _same(*calcs["unary"], geom)
    assert np.isclose(energy, -18.79979353611411)
    assert np.allclose(forces, [[-12.26367499, 0.15140673, 0.0],
                                [12.05608935, 0.31137845, 0.0],
                                [0.20758563, -0.46278518, 0.0]])


def test_unary_pbc(calcs):
    geom = JAtoms("W8",
                  positions=[[0.00, 0.00, 0.00], [2.89, 0.12, -0.04],
                             [-0.32, 2.71, -0.11], [2.65, 2.81, 0.37],
                             [0.00, 0.00, 3.00], [2.64, 0.00, 3.00],
                             [-0.08, 2.94, 3.16], [2.53, 2.87, 3.23]],
                  pbc=True, cell=np.eye(3) * 2.74 * 2)
    energy, forces = _same(*calcs["unary"], geom, stress=True)
    assert np.isclose(energy, -76.358888229785)
    assert np.allclose(forces,
                       [[1.36696442, -0.46307, 1.78573347],
                        [0.20112587, 0.17014795, 1.22172728],
                        [-0.66043959, -1.08374173, 6.78845939],
                        [-1.30913745, 0.36888897, 1.48182124],
                        [-0.33315563, 1.28359885, -1.56572912],
                        [0.01504262, 0.06574851, -2.38044283],
                        [0.25436762, 0.2491558, -7.48063062],
                        [0.46523214, -0.59072835, 0.14906119]])


def test_binary(calcs):
    geom = JAtoms("NeXe", positions=[[0, 0, 0], [3.1, 0, 0]], pbc=False)
    assert _factorized(calcs["binary"][1])
    energy, forces = _same(*calcs["binary"], geom)
    assert np.isclose(energy, 0.3464031387757268)
    assert np.allclose(forces, [[-0.28138023, 0.0, 0.0],
                                [0.28138023, 0.0, 0.0]])


def test_forces_match_finite_difference(calcs):
    jcalc, calc = calcs["unary"]
    geom = JAtoms("W3", positions=[[0, 0, 0], [2.1, 0, 0], [0.3, 2.8, 0]],
                  pbc=False)
    _, forces = _same(jcalc, calc, geom)
    eps = 1e-6
    for a in range(3):
        for c in range(3):
            plus, minus = _port(geom), _port(geom)
            plus.positions[a, c] += eps
            minus.positions[a, c] -= eps
            numeric = -(calc.get_potential_energy(plus)
                        - calc.get_potential_energy(minus)) / (2 * eps)
            assert np.isclose(forces[a, c], numeric, atol=1e-5)


def test_relaxation_dimer(lj):
    jcalc, calc = lj
    geom = JAtoms("W2", positions=[[0, 0, 0], [3.4, 0, 0]], pbc=False)
    relaxed = calc.relax_fmax(_port(geom), fmax=0.01, steps=300)
    r_final = np.linalg.norm(relaxed.positions[1] - relaxed.positions[0])
    # LJ minimum at 2^(1/6) * 2.5 = 2.806
    assert abs(r_final - 2.5 * 2 ** (1 / 6)) < 0.05
    ref = jcalc.relax_fmax(geom, fmax=0.01, steps=300)
    assert np.abs(relaxed.positions - ref.positions).max() < 1e-9


def _w(reps, rattle=0.05, seed=3):
    geom = jbulk("W", "bcc", a=3.1652) * reps
    geom.rattle(rattle, seed=seed)
    return geom


def test_bcc_w_2and3_rattled(calcs):
    """The fused shared route (the trio kernel's plain version) on
    rattled bcc W 3^3, f32 beside f64 on the same cached geometry."""
    jcalc, calc = calcs["w23"]
    geom = _w(3)
    assert calc.potential.trio is not None
    energy, forces = _same(jcalc, calc, geom, stress=True)
    calc32 = UFCalculator(MODEL_23, dtype=torch.float32, device="cpu")
    ours = _port(geom)
    assert np.abs(calc32.get_forces(ours) - forces).max() < 2e-4
    assert abs(calc32.get_potential_energy(ours) - energy) \
        < 1e-6 * abs(energy)


def test_capacity_overflow_regrows(calcs):
    """Structures whose first lists overflow regrow and match the
    reference, no result coming from a truncated list: a compact
    2+3-body cluster (sized as if it sat in 1e6 A^3: 8 slots for 21
    neighbors) and bcc W 3^3 at a = 3.35 A (13 3-body slots for 14
    neighbors within 3.5 A); the grown system is kept for the next
    structure of its signature."""
    jcalc, calc = calcs["w23"]
    ball = _w(3, rattle=0.02)
    center = ball.positions.mean(axis=0)
    ball.delete(np.where(np.linalg.norm(ball.positions - center, axis=1)
                         > 4.6)[0])
    ball.pbc = np.array([False] * 3)
    ball.cell = np.zeros((3, 3))
    assert len(ball) == 22
    fresh = UFCalculator(MODEL_23, device="cpu")
    _same(jcalc, fresh, ball)
    assert fresh.system.capacity_2b == fresh.system.capacity_3b == 21
    geom = jbulk("W", "bcc", a=3.35) * 3
    geom.rattle(0.05, seed=3)
    _same(jcalc, fresh, geom, stress=True)
    system = fresh.system
    assert system.capacity_3b > 14
    _same(jcalc, fresh, _w(3), stress=True)
    assert fresh.system is system


def test_batched_energy_and_relax(calcs):
    jcalc, calc = calcs["unary"]
    geoms = [JAtoms("W2", positions=[[0, 0, 0], [2.2 + 0.2 * i, 0, 0]])
             for i in range(3)]
    energies, forces = t_batch.batched_energy_and_forces(
        [_port(g) for g in geoms], calc)
    ref_e, ref_f = j_batch.batched_energy_and_forces(geoms, jcalc)
    assert len(energies) == 3 and all(np.isfinite(e) for e in energies)
    assert np.allclose(energies, ref_e, rtol=E_FUSED, atol=0)
    assert max(np.abs(a - b).max() for a, b in zip(forces, ref_f)) <= F_TOL
    relaxed, energies, forces = t_batch.batch_relax(
        [_port(g) for g in geoms], calc, fmax=0.1, max_steps=100)
    ref = j_batch.batch_relax(geoms, jcalc, fmax=0.1, max_steps=100)
    assert len(relaxed) == 3
    for ours, theirs in zip(relaxed, ref[0]):
        assert np.abs(ours.positions - theirs.positions).max() < 1e-6
    assert np.allclose(energies, ref[1], rtol=1e-8, atol=0)


def test_relax_with_cell(calcs):
    """Box relaxation of a strained bcc W cell: position FIRE and
    stress steps alternate on both packages; the stress is analytic in
    the port and numerical in the reference."""
    jcalc, calc = calcs["w23"]
    geom = jbulk("W", "bcc", a=3.22) * 2
    geom.rattle(0.01, seed=5)
    ours = t_opt.relax_with_cell(_port(geom), calc, fmax=0.02, smax=2e-3,
                                 max_steps=8)
    ref = j_opt.relax_with_cell(geom, jcalc, fmax=0.02, smax=2e-3,
                                max_steps=8)
    assert ours.info["relax_nsteps"] == ref.info["relax_nsteps"]
    assert np.abs(ours.cell - ref.cell).max() < 1e-6
    assert np.abs(ours.positions - ref.positions).max() < 1e-6


def test_elastic_constants_bcc_w(calcs):
    jcalc, calc = calcs["w23"]
    geom = jbulk("W", "bcc", a=3.1652) * 3
    res = t_elastic.get_elastic_constants(_port(geom), calc)
    assert 450 < res["C11"] < 620
    assert 120 < res["C12"] < 260
    assert 80 < res["C44"] < 220
    assert 250 < res["bulk_modulus"] < 360
    C = np.asarray(res["elastic_tensor"])
    assert np.allclose(C, C.T, atol=5.0)
    ref = j_elastic.get_elastic_constants(geom, jcalc)
    assert np.abs(C - ref["elastic_tensor"]).max() <= C_TOL
    for key in ("C11", "C12", "C44", "bulk_modulus"):
        assert abs(res[key] - ref[key]) <= C_TOL, key
    via = calc.get_elastic_constants(_port(geom))
    assert np.array_equal(via["elastic_tensor"], C)


def test_phonons_bcc_w(calcs):
    jcalc, calc = calcs["w23"]
    geom = jbulk("W", "bcc", a=3.1652)
    ph = t_phonon.compute_phonon_data(_port(geom), calc, n_super=3,
                                      n_points=8)
    f = np.asarray(ph["frequencies"])
    assert 5.0 < f.max() < 7.5
    assert f.min() > -0.05
    assert np.all(np.sort(np.abs(f[0]))[:3] < 0.05)
    ref = j_phonon.compute_phonon_data(geom, jcalc, n_super=3, n_points=8)
    assert np.abs(f - ref["frequencies"]).max() <= NU_TOL
    assert np.allclose(ph["distances"], ref["distances"], rtol=0, atol=1e-12)
    assert [lab for _, lab in ph["labels"]] \
        == [lab for _, lab in ref["labels"]]


def test_symmetry_reduced_force_constants(calcs):
    jcalc, calc = calcs["w23"]
    geom = jbulk("W", "bcc", a=3.1652)
    phi_full, _ = t_phonon.force_constants(_port(geom), calc, n_super=2,
                                           symmetry=False)
    phi_sym, _ = t_phonon.force_constants(_port(geom), calc, n_super=2,
                                          symmetry=True)
    scale = np.abs(phi_full).max()
    assert np.abs(phi_full - phi_sym).max() < 1e-8 * scale
    ref, _ = j_phonon.force_constants(geom, jcalc, n_super=2, symmetry=True)
    assert np.abs(phi_sym - ref).max() < 1e-6


def test_phonons_fcc_path(calcs):
    jcalc, calc = calcs["w23"]
    geom = jbulk("W", "fcc", a=4.05, cubic=False)
    ph = t_phonon.compute_phonon_data(_port(geom), calc, n_super=3,
                                      n_points=6)
    f = np.asarray(ph["frequencies"])
    assert f.shape[1] == 3
    assert np.all(np.abs(f[0]) < 0.05)
    ref = j_phonon.compute_phonon_data(geom, jcalc, n_super=3, n_points=6)
    assert np.abs(f - ref["frequencies"]).max() <= NU_TOL


class TestSymmetry:
    CASES = [(("W", "bcc", 3.16, False), 48), (("Cu", "fcc", 3.6, False), 48),
             (("W", "bcc", 3.16, True), 96), (("Mg", "hcp", 3.2, True), 24),
             (("Si", "diamond", 5.43, False), 48)]

    @pytest.mark.parametrize("spec, expected", CASES,
                             ids=[f"{c[0][1]}-{c[0][3]}" for c in CASES])
    def test_op_counts(self, spec, expected):
        symbol, structure, a, cubic = spec
        geom = jbulk(symbol, structure, a=a, cubic=cubic)
        ops = t_sym.find_symmetry_ops(_port(geom))
        assert len(ops) == expected
        ref = j_sym.find_symmetry_ops(geom)
        for op, op_ref in zip(ops, ref):
            assert np.array_equal(op.rotation, op_ref.rotation)
            assert np.array_equal(op.permutation, op_ref.permutation)
            assert np.allclose(op.cartesian @ op.cartesian.T, np.eye(3),
                               atol=1e-10)

    def test_lattice_detection(self):
        cases = {("Cu", "fcc", 3.6, False): "fcc",
                 ("W", "bcc", 3.16, False): "bcc",
                 ("Mg", "hcp", 3.2, True): "hex",
                 ("W", "bcc", 3.16, True): "cubic"}
        for (symbol, structure, a, cubic), lattice in cases.items():
            geom = jbulk(symbol, structure, a=a, cubic=cubic)
            assert t_phonon.detect_lattice(_port(geom)) == lattice
            assert j_phonon.detect_lattice(geom) == lattice
        cubic = t_atoms.bulk("W", "bcc", a=3.16)
        assert t_phonon.detect_lattice(cubic) == "cubic"
