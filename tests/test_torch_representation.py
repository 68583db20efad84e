"""
The port's host featurizer (``uf3_tpu_torch/representation/process.py``
on ``representation/featurize_np.py`` and ``data/geometry.py``) on the
CPU in float64:

- twins of ``TestGoldenEnergyFeatures`` (strained H2O, methane),
  ``TestInvariance``, ``TestEvaluate`` (its dataframe test on the
  fitting arrays of ``featurize_dataset``) and ``TestRattledSteelGolden``
  (``tests/test_representation.py``, against
  ``tests/data/rattled_steel_features.json``), and of ``TestSupercell``
  and ``TestDistances`` (``tests/test_geometry_distances.py``);
- the same configurations through ``uf3_tpu``'s ``BasisFeaturizer``
  (1e-12: the same numpy code);
- 3-body legs past the pair cutoff in cells smaller than the legs,
  against ``uf3_tpu``'s featurizer on a supercell twice its own depth
  (``DeepOracle``; its own drops force terms there, ROADMAP.md section
  3), and the energy features' finite differences.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from uf3_tpu.data import geometry as j_geometry
from uf3_tpu.data.atoms import Atoms as JAtoms
from uf3_tpu.data.composition import ChemicalSystem as JChem
from uf3_tpu.representation.basis import BSplineBasis as JBasis
from uf3_tpu.representation.process import BasisFeaturizer as JFeaturizer
from uf3_tpu_torch.data import elements, geometry
from uf3_tpu_torch.data.atoms import Atoms, bulk
from uf3_tpu_torch.data.composition import ChemicalSystem
from uf3_tpu_torch.representation import featurize_np as fnp
from uf3_tpu_torch.representation.basis import BSplineBasis
from uf3_tpu_torch.representation.process import (BasisFeaturizer,
                                                  flatten_by_interactions)

torch.set_num_threads(1)

SAME_CODE_TOL = 1e-12   # against uf3_tpu's host featurizer: one numpy code
ORACLE_TOL = 1e-9       # against the deep oracle (another supercell)


def atoms(formula, positions, cell=None, pbc=False) -> Atoms:
    """The port's Atoms from a formula such as "CH4"."""
    symbols = []
    for symbol, count in re.findall(r"([A-Z][a-z]?)(\d*)", formula):
        symbols += [symbol] * int(count or 1)
    cell = np.zeros((3, 3)) if cell is None else np.asarray(cell, float)
    if cell.shape == (3,):
        cell = np.diag(cell)
    return Atoms(elements.symbols_to_numbers(symbols), positions, cell,
                 pbc=pbc)


def reference_atoms(geom) -> JAtoms:
    return JAtoms(numbers=geom.get_atomic_numbers(),
                  positions=geom.get_positions(), cell=geom.get_cell(),
                  pbc=geom.get_pbc())


@pytest.fixture()
def strained_h2o():
    return atoms("H2O", [[0, 0, 0], [1.5, 0, 0], [0, 2.0, 0]])


@pytest.fixture()
def methane():
    return atoms("CH4", [[15.0, 15.0, 15.000010729],
                         [15.629117489, 15.629117489, 15.629128218],
                         [14.370881617, 14.370881617, 15.629128218],
                         [15.629117489, 14.370881617, 14.370892346],
                         [14.370881617, 15.629117489, 14.370892346]],
                 cell=[30, 30, 30], pbc=True)


@pytest.fixture()
def rattled_steel():
    return atoms("Fe8C3",
                 [[1.99342831e-01, 7.23471398e-02, 2.29537708e-01],
                  [3.27460597e+00, 3.16932506e-03, -9.68273914e-02],
                  [3.65842563e-01, 3.07348695e+00, -1.43894877e-01],
                  [3.02851201e+00, 2.85731646e+00, 6.85404929e-03],
                  [-1.60754569e-03, -3.82656049e-01, 2.57501643e+00],
                  [2.80754249e+00, -3.02566224e-01, 2.88284947e+00],
                  [-8.16048151e-02, 2.53753926e+00, 3.26312975e+00],
                  [2.92484474e+00, 2.93350564e+00, 2.58505036e+00],
                  [1.32612346e+00, 1.45718452e+00, -1.80198715e-01],
                  [1.51013960e+00, -7.01277380e-02, 1.37666125e+00],
                  [-7.03413224e-02, 1.80545564e+00, 1.43230056e+00]],
                 cell=[5.74, 5.74, 5.74], pbc=True)


def interaction_slices(bspline_config, features_con):
    """Slice the concatenated 2B+3B feature vector per interaction,
    skipping the 1-body columns (not present in features_con)."""
    sizes, offsets = bspline_config.get_interaction_partitions()
    n_el = len(bspline_config.element_list)
    out = {}
    for degree in (2, 3):
        for interaction in bspline_config.interactions_map.get(degree, []):
            start = offsets[interaction] - n_el
            out[interaction] = features_con[
                start:start + sizes[interaction]]
    return out


def energy_features(elements_, geom, degree=3):
    """The port's 2B+3B energy features and uf3_tpu's, which must be
    the same to 1e-12."""
    featurizer = BasisFeaturizer(BSplineBasis(ChemicalSystem(
        elements_, degree=degree)))
    ref = JFeaturizer(JBasis(JChem(elements_, degree=degree)))
    jgeom = reference_atoms(geom)
    con = np.concatenate([featurizer.featurize_energy_2B(geom),
                          featurizer.featurize_energy_3B(geom)])
    ref_con = np.concatenate([ref.featurize_energy_2B(jgeom),
                              ref.featurize_energy_3B(jgeom)])
    assert np.abs(con - ref_con).max() <= SAME_CODE_TOL
    return featurizer.bspline_config, con


class TestGoldenEnergyFeatures:
    def test_strained_h2o(self, strained_h2o):
        config, con = energy_features(["H", "O"], strained_h2o)
        feats = interaction_slices(config, con)
        assert np.allclose(feats[("H", "H")][:5],
                           [0.0, 0.40032798833819255, 1.1900510204081631,
                            0.40949951409135077, 0.00012147716229348758])
        assert np.allclose(feats[("H", "H")][5:], 0.0)
        assert np.allclose(feats[("H", "O")][:7],
                           [0.0, 0.0, 0.20991253644314867,
                            1.4571185617103986, 1.745019436345967,
                            0.5846695821185617, 0.0032798833819242057])
        assert np.allclose(feats[("O", "O")], 0.0)
        hho = feats[("H", "H", "O")]
        nz = np.where(hho != 0)[0]
        assert np.allclose(nz, [0, 1, 2, 7, 8, 9])
        assert np.allclose(hho[nz] * 2,
                           [0.11179061530876638, 0.02854780141611156,
                            5.380932829072594e-05, 0.046232917007898805,
                            0.00356407243123478, 4.6287594228581435e-06])
        ohh = feats[("O", "H", "H")]
        nz = np.where(ohh != 0)[0]
        assert np.allclose(nz, [0, 7, 14])
        assert np.allclose(ohh[nz] * 2,
                           [0.033415592868540726, 0.03629005247013563,
                            0.0028744596015948995])
        for key in [("H", "H", "H"), ("H", "O", "O"), ("O", "H", "O"),
                    ("O", "O", "O")]:
            assert np.allclose(feats[key], 0.0)

    def test_methane(self, methane):
        config, con = energy_features(["H", "C"], methane)
        feats = interaction_slices(config, con)
        assert np.allclose(feats[("H", "H")][:5],
                           [0.0, 0.10764117873003697, 4.380510760509621,
                            6.909855011070257, 0.6019930496900838])
        assert np.allclose(feats[("H", "C")][:4],
                           [4.217956715718236, 3.381599561086582,
                            0.3909862297136271, 0.009457493481554552])
        assert np.allclose(feats[("C", "C")], 0.0)
        hhh = feats[("H", "H", "H")]
        nz = np.where(hhh != 0)[0]
        assert np.allclose(nz, [0, 1, 7, 8, 14, 15])
        assert np.allclose(hhh[nz] * 2,
                           [0.6640224780125649, 0.0007053656017778708,
                            0.01702949612348602, 1.8089780359648227e-05,
                            0.00010918445829116121, 1.159824609519897e-07])
        hhc = feats[("H", "H", "C")]
        nz = np.where(hhc != 0)[0]
        assert np.allclose(nz, [0, 14])
        assert np.allclose(hhc[nz] * 2,
                           [1.624998081281485e-06, 2.083732060447781e-08])
        chh = feats[("C", "H", "H")]
        nz = np.where(chh != 0)[0]
        assert np.allclose(nz, [0, 1])
        assert np.allclose(chh[nz] * 2,
                           [8.505596144699058e-07, 9.035168449480808e-10])


class TestInvariance:
    def test_equal_order_key_swap(self):
        geom = atoms("Yb2La2", [[0, 0, 0], [0, 0, 2], [0, 1.5, 0],
                                [2, 0, 0]], cell=[30, 30, 30], pbc=True)
        f1 = BasisFeaturizer(BSplineBasis(
            ChemicalSystem(["Yb", "La"], degree=3))).featurize_energy_3B(geom)
        f2 = BasisFeaturizer(BSplineBasis(
            ChemicalSystem(["La", "Yb"], degree=3))).featurize_energy_3B(geom)
        assert np.allclose(f1, f2)

    def test_atom_order_swap_3b(self):
        config = BSplineBasis(ChemicalSystem(["C", "Pt"], degree=3))
        featurizer = BasisFeaturizer(config)
        g1 = atoms("CPtC", [[0, 0, 0], [0, 1.5, 0], [0, 0, 2]],
                   cell=[30, 30, 30], pbc=True)
        g2 = atoms("CCPt", [[0, 0, 0], [0, 0, 2], [0, 1.5, 0]],
                   cell=[30, 30, 30], pbc=True)
        f1 = featurizer.featurize_energy_3B(g1)
        f2 = featurizer.featurize_energy_3B(g2)
        assert np.allclose(f1[f1 != 0], f2[f2 != 0])


class TestEvaluate:
    def test_evaluate_shapes(self):
        featurizer = BasisFeaturizer(BSplineBasis(ChemicalSystem(["Ar"])))
        geom = atoms("Ar3", [[0, 0, 0], [3, 0, 0], [0, 4, 0]])
        eval_map = featurizer.evaluate_configuration(geom, energy=1.5)
        assert len(eval_map["energy"]) == 1 + 18 + 1
        assert eval_map["energy"][0] == 1.5
        assert eval_map["energy"][1] == 3
        eval_map = featurizer.evaluate_configuration(
            geom, name="sample",
            forces=[[2, 0, 0], [0, 0, 0], [0, 0, 0]])
        assert len(eval_map) == 9
        assert eval_map[("sample", "fx_0")][0] == 2
        assert eval_map[("sample", "fy_1")][1] == 0
        assert len(eval_map[("sample", "fz_2")]) == 20

    def test_evaluate_dataset(self):
        """The dataframe twin on the fitting arrays: energy rows per atom,
        force rows fx..., fy..., fz... per configuration, and no force
        rows for a configuration without forces or with ``fit_forces``
        off."""
        featurizer = BasisFeaturizer(BSplineBasis(ChemicalSystem(["Ar"])))
        geom = atoms("Ar3", [[0, 0, 0], [3, 0, 0], [0, 4, 0]])
        forces = [np.array([[4., 0, 2], [3, 1, 1], [0, 2, 0]]),
                  np.array([[4.1, 0, 2], [3.1, 1.1, 1], [0, 2.1, 0]])]
        x_e, y_e, x_f, y_f = featurizer.featurize_dataset(
            [geom, geom], [1.5, 1.5], forces)
        assert x_e.shape == (2, 1 + 18) and x_f.shape == (2 * 9, 1 + 18)
        assert np.allclose(y_e, [0.5, 0.5])
        assert np.allclose(x_e[:, 0], 1.0)   # the atom count, per atom
        assert np.allclose(y_f[:9], [4, 3, 0, 0, 1, 2, 2, 1, 0])
        rows = featurizer.evaluate_configuration(geom, energy=1.5,
                                                 forces=forces[0].T)
        assert np.array_equal(x_e[0] * 3, rows["energy"][1:])
        for c, name in enumerate("xyz"):
            for a in range(3):
                assert np.array_equal(x_f[3 * c + a], rows[f"f{name}_{a}"][1:])
        x_e2, _, x_f2, y_f2 = featurizer.featurize_dataset(
            [geom, geom], [1.5, 1.5], [None, forces[1]])
        assert np.array_equal(x_e2, x_e) and x_f2.shape == (9, 19)
        assert np.array_equal(x_f2, x_f[9:]) and np.array_equal(
            y_f2, y_f[9:])
        featurizer.fit_forces = False
        x_e3, _, x_f3, y_f3 = featurizer.featurize_dataset(
            [geom, geom], [1.5, 1.5], forces)
        assert np.array_equal(x_e3, x_e)
        assert x_f3.shape == (0, 19) and y_f3.shape == (0,)


class TestRattledSteelGolden:
    def test_energy_and_forces(self, rattled_steel, data_dir):
        chemistry = ChemicalSystem(["Fe", "C"], degree=3)
        trios = chemistry.interactions_map[3]
        pairs = chemistry.interactions_map[2]
        config = BSplineBasis(
            chemistry,
            r_min_map={**{p: 0.1 for p in pairs},
                       **{t: [1.5] * 3 for t in trios}},
            r_max_map={**{p: 6.0 for p in pairs},
                       **{t: [5.0, 5.0, 10.0] for t in trios}},
            resolution_map={**{p: 12 for p in pairs},
                            **{t: [4, 4, 8] for t in trios}},
            knot_strategy="linear", offset_1b=True,
            leading_trim=0, trailing_trim=3)
        featurizer = BasisFeaturizer(config)
        n_atoms = len(rattled_steel)
        eval_map = featurizer.evaluate_configuration(
            rattled_steel, energy=0, forces=np.zeros((3, n_atoms)))
        with open(os.path.join(data_dir,
                               "rattled_steel_features.json")) as f:
            ref = json.load(f)
        assert set(eval_map) == set(ref)
        for key in eval_map:
            assert np.allclose(eval_map[key], np.array(ref[key]),
                               atol=1e-10), key


def test_flatten_by_interactions():
    vector_map = {("A", "A"): np.array([1, 1, 1]),
                  ("A", "B"): np.array([2, 2]),
                  ("B", "B"): np.array([3, 3, 3, 3])}
    out = flatten_by_interactions(vector_map,
                                  [("A", "A"), ("A", "B"), ("B", "B")])
    assert np.array_equal(out, [1, 1, 1, 2, 2, 3, 3, 3, 3])


class TestSupercell:
    def test_replica_counts_sc(self):
        geom = atoms("W2", [[0, 0, 0], [2, 2, 2]], cell=np.eye(3) * 4,
                     pbc=True)
        supercell = geometry.get_supercell(geom, r_cut=6.0)
        assert len(supercell) == 2 * 125

    def test_first_image_is_unit_cell(self):
        geom = bulk("W", "bcc", a=3.16)
        supercell = geometry.get_supercell(geom, r_cut=5.0)
        assert np.allclose(supercell.positions[:len(geom)],
                           geom.positions)
        assert np.all(supercell.get_atomic_numbers()[:len(geom)]
                      == geom.get_atomic_numbers())
        ref = j_geometry.get_supercell(reference_atoms(geom), r_cut=5.0)
        assert np.array_equal(supercell.get_positions(), ref.get_positions())

    def test_low_dimensional(self):
        geom = atoms("W", [[0, 0, 0]], cell=np.eye(3) * 4,
                     pbc=[True, True, False])
        supercell = geometry.get_supercell(geom, r_cut=4.0)
        assert len(supercell) == 9

    def test_mask_supercell_with_radius(self):
        geom = bulk("W", "bcc", a=3.16)
        supercell = geometry.get_supercell(geom, r_cut=5.0)
        masked = geometry.mask_supercell_with_radius(geom, supercell, 5.0)
        assert len(masked) < len(supercell)
        matrix = geometry.get_distance_matrix(geom, masked)
        assert np.all(np.min(matrix, axis=0) <= 5.0)
        ref = j_geometry.mask_supercell_with_radius(
            reference_atoms(geom), j_geometry.get_supercell(
                reference_atoms(geom), r_cut=5.0), 5.0)
        assert np.array_equal(masked.get_positions(), ref.get_positions())
        assert np.array_equal(matrix, j_geometry.get_distance_matrix(
            reference_atoms(geom), ref))

    @pytest.mark.parametrize("random", [True, False])
    def test_displacements_from_forces_match_uf3_tpu(self, random):
        geom = bulk("W", "bcc", a=3.16) * 2
        forces = np.random.RandomState(1).normal(size=(len(geom), 3))
        ours = geometry.generate_displacements_from_forces(
            geom, -10.0, forces, n=4, random=random)
        ref = j_geometry.generate_displacements_from_forces(
            reference_atoms(geom), -10.0, forces, n=4, random=random)
        assert len(ours[0]) == len(ref[0]) == (4 if random else 48)
        assert np.array_equal(ours[1], ref[1])
        for a, b in zip(ours[0], ref[0]):
            assert np.array_equal(a.get_positions(), b.get_positions())


class TestDistances:
    def test_dimer_distances(self):
        geom = atoms("W2", [[0, 0, 0], [2.5, 0, 0]])
        cs = ChemicalSystem(["W"])
        out = fnp.distances_by_interaction(
            geom, cs.interactions_map[2],
            {("W", "W"): 1.0}, {("W", "W"): 6.0})
        assert np.allclose(sorted(out[("W", "W")]), [2.5, 2.5])

    def test_binary_species_masks(self):
        geom = atoms("NeXe", [[0, 0, 0], [3.0, 0, 0]])
        cs = ChemicalSystem(["Ne", "Xe"])
        r_min = {pair: 0.5 for pair in cs.interactions_map[2]}
        r_max = {pair: 6.0 for pair in cs.interactions_map[2]}
        out = fnp.distances_by_interaction(
            geom, cs.interactions_map[2], r_min, r_max)
        assert len(out[("Ne", "Ne")]) == 0
        assert len(out[("Xe", "Xe")]) == 0
        assert np.allclose(sorted(out[("Ne", "Xe")]), [3.0, 3.0])

    def test_periodic_bcc_first_shell(self):
        geom = bulk("W", "bcc", a=3.16)
        supercell = geometry.get_supercell(geom, r_cut=3.0)
        out = fnp.distances_by_interaction(
            geom, [("W", "W")], {("W", "W"): 1.0}, {("W", "W"): 3.0},
            supercell=supercell)
        nn = 3.16 * np.sqrt(3) / 2
        distances = out[("W", "W")]
        assert len(distances) == 2 * 8
        assert np.allclose(distances, nn)

    def test_derivatives_force_consistency(self):
        geom = atoms("W3", [[0, 0, 0], [2.2, 0, 0], [0.5, 2.4, 0]])
        dist_map, deriv_map = fnp.derivatives_by_interaction(
            geom, [("W", "W")], 6.0, {("W", "W"): 1.0},
            {("W", "W"): 6.0})
        i_idx, j_idx, unit = deriv_map[("W", "W")]
        assert np.allclose(np.linalg.norm(unit, axis=1), 1.0)
        pairs = set(zip(i_idx.tolist(), j_idx.tolist()))
        assert (0, 1) in pairs and (1, 0) in pairs


# 3-body legs (5.5, 5.5, 11) A past the 3 A pair cutoff, on knots with no
# closed form (the host route's bases): each leg's interior knots moved
LONG_LEGS = dict(
    r_min_map={("W", "W"): 1.5, ("W", "W", "W"): [1.5] * 3},
    r_max_map={("W", "W"): 3.0, ("W", "W", "W"): [5.5, 5.5, 11.0]},
    resolution_map={("W", "W"): 8, ("W", "W", "W"): [5, 5, 10]})


def irregular(basis_cls, chem_cls):
    """The LONG_LEGS basis with every interior knot moved by a seeded
    fraction of its gap: no closed form.  The two center legs keep one
    sequence (a trio of one species whose center legs differ is not
    invariant under the swap of its neighbors)."""
    basis = basis_cls(chem_cls(["W"], degree=3), **LONG_LEGS)
    rng = np.random.RandomState(4)

    def move(seq):
        seq = np.array(seq, dtype=float)
        gap = seq[4] - seq[3]
        seq[4:-4] += rng.uniform(-0.2, 0.2, len(seq) - 8) * gap
        return seq
    knots = {pair: move(seq) for pair, seq in basis.knots_map.items()
             if len(pair) == 2}
    for trio, seqs in basis.knots_map.items():
        if len(trio) == 3:
            center = move(seqs[0])
            knots[trio] = [center, center, move(seqs[2])]
    return knots


class DeepOracle(JFeaturizer):
    """uf3_tpu's host featurizer on a ghost supercell twice as deep as
    its own (``tests/test_torch_featurize.py``)."""
    r_cut = property(lambda self: 2.0 * self.bspline_config.r_cut)


@pytest.mark.parametrize("reps", [1, 2])
def test_long_trio_legs_match_deep_oracle(reps):
    """The host route on knots with no closed form and 3-body legs past
    the pair cutoff, in cells smaller than the legs (bcc W 1^3 and 2^3):
    against uf3_tpu's featurizer on a supercell deep enough (1e-9),
    whose own supercell drops force terms in the 1^3 cell; and the force
    features against central differences of the port's own energy
    features (h = 1e-5 A, 1e-6)."""
    knots = irregular(JBasis, JChem)
    ref_basis = JBasis(JChem(["W"], degree=3), knots_map=knots)
    basis = BSplineBasis(ChemicalSystem(["W"], degree=3), knots_map=knots)
    featurizer = BasisFeaturizer(basis)
    assert featurizer.supercell_cutoff == 11.0
    geom = bulk("W", "bcc", a=3.1652) * reps
    geom.rattle(0.1, seed=reps)
    n_atoms = len(geom)
    jgeom = reference_atoms(geom)
    vector, vectors = featurizer.featurize_configuration(geom)
    ref = DeepOracle(ref_basis).evaluate_configuration(
        jgeom, energy=0.0, forces=np.zeros((3, n_atoms)))
    assert np.abs(vector - np.array(ref["energy"])[1:]).max() \
        <= ORACLE_TOL
    ref_f = np.stack([[np.array(ref[f"f{c}_{a}"])[1:] for c in "xyz"]
                      for a in range(n_atoms)])
    assert np.abs(vectors - ref_f).max() <= ORACLE_TOL
    shallow = JFeaturizer(ref_basis).evaluate_configuration(
        jgeom, energy=0.0, forces=np.zeros((3, n_atoms)))
    shallow_f = np.stack([[np.array(shallow[f"f{c}_{a}"])[1:]
                           for c in "xyz"] for a in range(n_atoms)])
    if reps == 1:
        assert np.abs(shallow_f - ref_f).max() > 1e-2
    h = 1e-5
    for a, c in ((0, 0), (n_atoms - 1, 2)):
        energies = []
        for sign in (1.0, -1.0):
            moved = geom.copy()
            x = moved.get_positions()
            x[a, c] += sign * h
            moved.set_positions(x)
            energies.append(featurizer.featurize_configuration(
                moved, with_forces=False)[0])
        fd = -(energies[0] - energies[1]) / (2.0 * h)
        assert np.abs(vectors[a, c] - fd).max() <= 1e-6
