"""
The port's host fitting and data tools against ``uf3_tpu``'s, on the
same inputs: cutoff optimization by column dropping
(``regression/optimize.py``, twin of ``TestOptimize`` in
tests/test_auxiliary.py), distance analysis (``data/analyze.py``, twin of
``TestAnalyze``), the least-squares functions and models and the
pair-spline post-processing (``regression/least_squares.py``, twins of
tests/test_least_squares.py), the knot and 1D-spline helpers (twins of
``test_subintervals`` and ``test_fit_spline_1d`` in
tests/test_bsplines.py), the small element, atoms, composition, basis
and settings helpers, the vasprun.xml and LAMMPS readers (on small files
written here: the reference tests' data directory is not in the
repository), the ASE adapter without ase (twins of
``test_import_without_ase`` and ``test_from_ase_duck_typed``), and the
plots (twins of tests/test_plotting.py, Agg backend).  Products that
run on a device run with ``device="cpu"``.
"""

import os

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from uf3_tpu.data import analyze as j_analyze  # noqa: E402
from uf3_tpu.data import atoms as j_atoms  # noqa: E402
from uf3_tpu.data import composition as j_comp  # noqa: E402
from uf3_tpu.data import elements as j_el  # noqa: E402
from uf3_tpu.data import io as j_io  # noqa: E402
from uf3_tpu.regression import least_squares as j_ls  # noqa: E402
from uf3_tpu.regression import optimize as j_opt  # noqa: E402
from uf3_tpu.representation import basis as j_basis  # noqa: E402
from uf3_tpu.representation import knots as j_kn  # noqa: E402
from uf3_tpu.representation import splines as j_sp  # noqa: E402
from uf3_tpu.util import plotting3d as j_p3  # noqa: E402
from uf3_tpu.util import user_config as j_uc  # noqa: E402
from uf3_tpu_torch.data import analyze, geometry, io  # noqa: E402
from uf3_tpu_torch.data.atoms import (Atoms, bulk,  # noqa: E402
                                      molecule_from_arrays)
from uf3_tpu_torch.data import composition, elements  # noqa: E402
from uf3_tpu_torch.forcefield import ase_adapter  # noqa: E402
from uf3_tpu_torch.regression import least_squares as ls  # noqa: E402
from uf3_tpu_torch.regression import optimize  # noqa: E402
from uf3_tpu_torch.representation import knots as kn  # noqa: E402
from uf3_tpu_torch.representation import splines as sp  # noqa: E402
from uf3_tpu_torch.representation.basis import BSplineBasis  # noqa: E402
from uf3_tpu_torch.representation.process import \
    BasisFeaturizer  # noqa: E402
from uf3_tpu_torch.util import plotting3d as p3  # noqa: E402
from uf3_tpu_torch.util import user_config  # noqa: E402

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of a thread per core oversubscribes them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "benchmarks_data", "model_2and3.json")
OPT = dict(rmin_2b=1.0, rmin_3b=1.0, rmax_2b=6.0, rmax_3b=4.0,
           knot_spacing_2b=0.5, knot_spacing_3b=0.5, leading_trim=0,
           trailing_trim=3)


# -- cutoff optimization ----------------------------------------------------
class TestOptimize:
    def test_cutoff_consistency(self):
        """Dropping columns from a big-cutoff featurization equals
        featurizing at the small cutoff (1e-10); the configs, cutoffs
        and dropped columns are uf3_tpu's."""
        chemistry = composition.ChemicalSystem(["W"], degree=3)
        config = optimize.get_bspline_config(chemistry, **OPT)
        ref = j_opt.get_bspline_config(j_comp.ChemicalSystem(["W"], 3),
                                       **OPT)
        for key, seqs in ref.knots_map.items():
            seqs = [seqs] if len(key) == 2 else seqs
            ours = config.knots_map[key]
            ours = [ours] if len(key) == 2 else ours
            assert all(np.array_equal(a, b) for a, b in zip(ours, seqs))
        featurizer = BasisFeaturizer(config)
        geom = bulk("W", "bcc", a=3.16)
        geom.rattle(0.03, seed=0)
        big = np.concatenate([featurizer.featurize_energy_2B(
            geom, geometry.get_supercell(geom, r_cut=config.r_cut)),
            featurizer.featurize_energy_3B(
                geom, geometry.get_supercell(geom, r_cut=config.r_cut))])
        names = config.get_column_names()[1 + 1:]  # drop y and n_W
        cutoffs = optimize.get_lower_cutoffs(config)
        ref_cutoffs = j_opt.get_lower_cutoffs(ref)
        for key in ref_cutoffs:
            assert np.array_equal(cutoffs[key], ref_cutoffs[key])
        for r2 in cutoffs["lower_rmax_2b"][-2:]:
            drop2 = optimize.get_columns_to_drop_2b(config, r2, 0.5)
            assert drop2 == j_opt.get_columns_to_drop_2b(ref, r2, 0.5)
            small_config = optimize.get_bspline_config(
                chemistry, **dict(OPT, rmax_2b=float(r2)))
            small_feat = BasisFeaturizer(small_config)
            supercell = geometry.get_supercell(
                geom, r_cut=small_config.r_cut)
            small = np.concatenate([
                small_feat.featurize_energy_2B(geom, supercell),
                small_feat.featurize_energy_3B(geom, supercell)])
            keep = [i for i, name in enumerate(names)
                    if name not in set(drop2)]
            assert np.allclose(big[keep], small, atol=1e-10)

    def test_columns_to_drop_3b(self):
        chemistry = composition.ChemicalSystem(["W"], degree=3)
        config = optimize.get_bspline_config(chemistry, **OPT)
        drop3 = optimize.get_columns_to_drop_3b(config, 3.5, 0.5)
        assert len(drop3) > 0
        assert set(drop3) <= set(config.get_column_names())
        ref = j_opt.get_bspline_config(j_comp.ChemicalSystem(["W"], 3),
                                       **OPT)
        assert drop3 == j_opt.get_columns_to_drop_3b(ref, 3.5, 0.5)

    def test_invalid_spacing_raises(self):
        chemistry = composition.ChemicalSystem(["W"], degree=3)
        with pytest.raises(ValueError, match="knot_spacing_2b"):
            optimize.get_bspline_config(chemistry,
                                        **dict(OPT, knot_spacing_2b=0.7))


# -- distance analysis ------------------------------------------------------
class TestAnalyze:
    def test_rdf_and_bounds(self):
        chemistry = composition.ChemicalSystem(["W"])
        geom = bulk("W", "bcc", a=3.16)
        histogram, edges, bounds = analyze.summarize_distances(
            [geom], chemistry, r_cut=6.0, n_bins=60, print_stats=False)
        pair = ("W", "W")
        # nearest-neighbor distance in bcc: sqrt(3)/2 * a = 2.737
        assert 2.5 < bounds[pair] < 2.85
        assert np.any(histogram[pair] > 0)
        ref = j_analyze.summarize_distances(
            [j_atoms.bulk("W", "bcc", a=3.16)],
            j_comp.ChemicalSystem(["W"]), r_cut=6.0, n_bins=60,
            print_stats=False)
        assert np.allclose(histogram[pair], ref[0][pair], atol=1e-12)
        assert np.array_equal(edges, ref[1]) and bounds == ref[2]

    def test_analyzer_suggestions_match(self):
        chemistry = composition.ChemicalSystem(["Ne", "Xe"])
        geom = bulk("Ne", "fcc", a=5.4) * 2
        geom.numbers[::3] = 54
        geom.rattle(0.1, seed=2)
        ours = analyze.DataAnalyzer(chemistry, r_cut=8.0, bins=80)
        ours.load_entries([geom])
        ref_geom = j_atoms.Atoms(numbers=geom.numbers,
                                 positions=geom.positions, cell=geom.cell,
                                 pbc=True)
        ref = j_analyze.DataAnalyzer(j_comp.ChemicalSystem(["Ne", "Xe"]),
                                     r_cut=8.0, bins=80)
        ref.load_entries([ref_geom])
        assert ours.analyze() == ref.analyze()

    def test_atomic_volumes(self):
        pytest.importorskip("sklearn")
        chemistry = composition.ChemicalSystem(["W"])
        analyzer = analyze.DataAnalyzer(chemistry)
        geoms = [bulk("W", "bcc", a=a) for a in (3.1, 3.16, 3.2)]
        volumes = analyzer.atomic_volumes(geoms)
        expected = 3.16 ** 3 / 2
        assert abs(volumes["W"] - expected) < 2.0


# -- least squares ----------------------------------------------------------
def simple_problem(n_features, n_samples, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n_samples, n_features)
    c = rng.rand(n_features)
    return x, np.dot(x, c), c


def test_basic_model_fit_predict_score():
    x, y, c = simple_problem(20, 500, seed=0)
    model = ls.BasicLinearModel(regularizer=np.eye(20) * 1e-6,
                                device="cpu")
    model.fit(x, y)
    ref = j_ls.BasicLinearModel(regularizer=np.eye(20) * 1e-6)
    ref.fit(x, y)
    assert np.allclose(model.coefficients, c)
    assert np.abs(model.coefficients - ref.coefficients).max() < 1e-10
    assert np.allclose(model.predict(x), y)
    assert model.score(x, y) < 1e-6
    assert abs(model.score(x, y) - ref.score(x, y)) < 1e-10
    ridge = ls.BasicLinearModel(device="cpu")
    ridge.fit(x, y, ridge_penalty=1e-3)
    ref_ridge = j_ls.BasicLinearModel()
    ref_ridge.fit(x, y, ridge_penalty=1e-3)
    assert np.abs(ridge.coefficients - ref_ridge.coefficients).max() < 1e-10


def test_linear_and_weighted_least_squares():
    x, y, c = simple_problem(10, 30, seed=0)
    assert np.allclose(ls.linear_least_squares(x, y, device="cpu"), c)
    assert np.abs(ls.linear_least_squares(x, y, device="cpu")
                  - j_ls.linear_least_squares(x, y)).max() < 1e-10
    x1, y1, c1 = simple_problem(5, 10, seed=0)
    x2, y2, c2 = simple_problem(5, 20, seed=1)
    x = np.concatenate([x1, x2])
    y = np.concatenate([y1, y2])
    w1 = np.concatenate([np.ones(10), np.zeros(20)])
    assert np.allclose(ls.weighted_least_squares(x, y, w1, device="cpu"),
                       c1)
    w2 = np.concatenate([np.zeros(10), np.ones(20)])
    assert np.allclose(ls.weighted_least_squares(x, y, w2, device="cpu"),
                       c2)
    w3 = np.full(30, 0.5)
    reg = np.eye(5) * 0.1
    blended = ls.weighted_least_squares(x, y, w3, regularizer=reg,
                                        device="cpu")
    assert not np.allclose(blended, c1) and not np.allclose(blended, c2)
    assert np.abs(blended - j_ls.weighted_least_squares(
        x, y, w3, regularizer=reg)).max() < 1e-10


@pytest.mark.parametrize("n_samples, batch_size", [(30, 2500), (7001, 2500)])
def test_moore_penrose_components(n_samples, batch_size):
    x, y, _ = simple_problem(12, n_samples, seed=4)
    ours = ls.batched_moore_penrose(x, y, batch_size, device="cpu")
    ref = j_ls.batched_moore_penrose(x, y, batch_size)
    for a, b in zip(ours, ref):
        assert np.abs(a - b).max() < 1e-9 * np.abs(b).max()
    gram, ordinate = ls.moore_penrose_components(x, y, device="cpu")
    assert np.allclose(gram, x.T @ x) and np.allclose(ordinate, x.T @ y)


def test_postprocess_coefficients_2b_and_well():
    coefficients = np.array([0.0, 0.0, 1.0, 0.5, -1.0, -0.5, 0.0, 0.0])
    out = ls.postprocess_coefficients_2b(coefficients, min_core=2.0,
                                         smooth_cutoff=True)
    assert out[0] >= 2.0
    assert np.all(out[-2:] == 0)
    assert np.all(np.diff(out[:3]) <= 0)
    rng = np.random.RandomState(8)
    for _ in range(20):
        c = rng.normal(0.0, 1.0, 12)
        for kw in ({}, dict(smooth_cutoff=True, rounding_factor=2)):
            assert np.array_equal(ls.postprocess_coefficients_2b(c, **kw),
                                  j_ls.postprocess_coefficients_2b(c, **kw))
        assert ls.find_pair_potential_well(c, 3) \
            == j_ls.find_pair_potential_well(c, 3)
    flat = np.array([1.0, 1.0, 1.0, 2.0, -1.0, 0.0])
    assert ls.find_pair_potential_well(flat, 3) == 4


def test_model_dump_arrange_and_fix_repulsion():
    """``dump``, ``arrange_coefficients``, the Taylor expansion and
    ``fix_repulsion_2b`` on the bench model with a coverage gap at the
    core: the same coefficients as uf3_tpu's."""
    ours = ls.WeightedLinearModel.from_json(MODEL, device="cpu")
    ref = j_ls.WeightedLinearModel.from_json(MODEL)
    pair = ("W", "W")
    solution = ls.arrange_coefficients(ours.coefficients,
                                       ours.bspline_config)
    ref_solution = j_ls.arrange_coefficients(ref.coefficients,
                                             ref.bspline_config)
    assert solution.keys() == ref_solution.keys()
    for key in solution:
        assert np.array_equal(solution[key], ref_solution[key])
    assert ours.dump().keys() == ours.as_dict().keys()
    knots = ours.bspline_config.knots_map[pair]
    r = np.linspace(1.6, 2.0, 7)
    expansion = ls.get_spline_taylor_expansion(
        2.2, r, solution[pair], knots, min_curvature=2.0)
    assert np.array_equal(expansion, j_ls.get_spline_taylor_expansion(
        2.2, r, ref_solution[pair], knots, min_curvature=2.0))
    sizes, offsets = ours.bspline_config.get_interaction_partitions()
    coverage = np.ones(ours.n_feats, dtype=bool)
    coverage[offsets[pair]:offsets[pair] + 5] = False
    for model in (ours, ref):
        model.data_coverage = coverage.copy()
        model.fix_repulsion_2b(pair)
    assert np.abs(ours.coefficients - ref.coefficients).max() < 1e-12
    assert not np.array_equal(ours.coefficients,
                              ls.WeightedLinearModel.from_json(
                                  MODEL, device="cpu").coefficients)


# -- knots, splines and the small helpers -----------------------------------
def test_subintervals_and_validation():
    seq = kn.knot_sequence_from_points([1, 2, 3])
    subs = kn.get_knot_subintervals(seq)
    assert np.allclose(subs[0], [1, 1, 1, 1, 2])
    assert np.allclose(subs[2], [1, 1, 2, 3, 3])
    assert np.allclose(subs[4], [2, 3, 3, 3, 3])
    for got, want in zip(subs, j_kn.get_knot_subintervals(seq)):
        assert np.array_equal(got, want)
    for seq in (kn.generate_lammps_knots(1, 6, 5), [0, 0, 0, 1, 2, 2, 2, 2],
                [0, 0, 0, 0, 2, 1, 3, 3, 3, 3]):
        assert kn.validate_knot_sequence(seq) \
            == j_kn.validate_knot_sequence(seq)
    assert kn.validate_knot_sequence(kn.generate_lammps_knots(1, 6, 5))


def test_fit_spline_1d():
    x = np.linspace(-1, 7, 1000)
    y = np.sin(x) + 0.5 * x
    seq = kn.generate_lammps_knots(0, 6, 5)
    coeff = sp.fit_spline_1d(x, y, seq)
    assert np.allclose(np.round(coeff, 2),
                       [-0.06, 1.59, 2.37, 1.16, 1.23, 1.77, 2.43, 2.71])
    assert np.array_equal(coeff, j_sp.fit_spline_1d(x, y, seq))
    mask = (x > 0) & (x < 6)
    yp = sp.evaluate_spline(x[mask], seq, coeff)
    assert np.sqrt(np.mean((y[mask] - yp) ** 2)) < 0.017
    ridge = sp.fit_spline_1d_ridge(x, y, seq)
    assert np.abs(ridge - j_sp.fit_spline_1d_ridge(x, y, seq)).max() < 1e-10


def test_small_helpers_match_uf3_tpu():
    assert elements.numbers_to_symbols([74, 10, 54]) \
        == j_el.numbers_to_symbols([74, 10, 54])
    geom = bulk("W", "bcc", a=3.1652) * 2
    geom.numbers[::3] = 54
    ref = j_atoms.Atoms(numbers=geom.numbers, positions=geom.positions,
                        cell=geom.cell, pbc=True)
    assert geom.get_chemical_formula() == ref.get_chemical_formula()
    assert repr(geom) == repr(ref)
    symbols = ["O", "H", "H"]
    positions = [[0, 0, 0], [0.96, 0, 0], [-0.24, 0.93, 0]]
    mol = molecule_from_arrays(symbols, positions)
    ref_mol = j_atoms.molecule_from_arrays(symbols, positions)
    assert np.array_equal(mol.numbers, ref_mol.numbers)
    assert np.array_equal(mol.pbc, ref_mol.pbc) and not mol.pbc.any()
    for syms in (("W", "W"), ("Ne", "Xe"), ("W", "Ne", "Xe")):
        h = composition.symbols_to_hash(syms)
        assert h == j_comp.symbols_to_hash(syms)
        assert composition.hash_to_symbols(h, len(syms)) \
            == j_comp.hash_to_symbols(h, len(syms))
    config = dict(element_list=["Xe", "Ne"], degree=3)
    chem = composition.ChemicalSystem.from_config(config)
    assert repr(chem) == repr(j_comp.ChemicalSystem.from_config(config))
    basis_config = dict(config, r_max_map={("Ne", "Ne"): 5.0})
    basis = BSplineBasis.from_config(basis_config)
    ref_basis = j_basis.BSplineBasis.from_config(basis_config)
    assert repr(basis) == repr(ref_basis)
    for string in ("W-W", "NeXe", "Xe-Ne-W"):
        assert user_config.get_element_tuple(string) \
            == j_uc.get_element_tuple(string)


# -- readers ----------------------------------------------------------------
VASPRUN = """<?xml version="1.0" encoding="ISO-8859-1"?>
<modeling>
 <atominfo>
  <atoms>2</atoms>
  <array name="atoms">
   <dimension dim="1">ion</dimension>
   <set>
    <rc><c>W </c><c>1</c></rc>
    <rc><c>W </c><c>1</c></rc>
   </set>
  </array>
 </atominfo>
{steps}
</modeling>
"""
STEP = """ <calculation>
  <structure>
   <crystal>
    <varray name="basis">
     <v> {a} 0.0 0.0 </v>
     <v> 0.0 {a} 0.0 </v>
     <v> 0.0 0.0 {a} </v>
    </varray>
   </crystal>
   <varray name="positions">
    <v> 0.0 0.0 0.0 </v>
    <v> 0.5 0.5 {z} </v>
   </varray>
  </structure>
  <varray name="forces">
   <v> 0.1 -0.2 {f} </v>
   <v> -0.1 0.2 {g} </v>
  </varray>
  <energy>
   <i name="e_fr_energy"> {e} </i>
   <i name="e_0_energy"> 0.0 </i>
  </energy>
 </calculation>"""


def _vasprun(path):
    steps = "\n".join(STEP.format(a=3.16 + 0.01 * i, z=0.5 + 0.01 * i,
                                  f=0.3 * i, g=-0.3 * i, e=-25.0 + 0.1 * i)
                      for i in range(3))
    with open(path, "w") as f:
        f.write(VASPRUN.format(steps=steps))


def _same_atoms(ours, ref):
    assert np.array_equal(ours.numbers, ref.numbers)
    assert np.allclose(ours.positions, ref.positions, atol=1e-12)
    assert np.allclose(ours.cell, ref.cell, atol=1e-12)
    assert np.array_equal(ours.pbc, ref.pbc)


def test_read_vasprun_and_read_sources(tmp_path):
    path = str(tmp_path / "vasprun.xml")
    _vasprun(path)
    ours, ref = io.read_vasprun(path), j_io.read_vasprun(path)
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        _same_atoms(a, b)
        assert a.info["energy"] == b.info["energy"]
        for c in ("fx", "fy", "fz"):
            assert np.array_equal(a.arrays[c], b.arrays[c])
    io.write_xyz(str(tmp_path / "frames.xyz"), ours[:2])
    keys, geoms = io.read_sources([path, str(tmp_path / "frames.xyz")])
    assert keys == ["vasprun.xml_0", "vasprun.xml_1", "vasprun.xml_2",
                    "frames.xyz_0", "frames.xyz_1"]
    assert [g.info["energy"] for g in geoms] \
        == [g.info["energy"] for g in ours] + [ours[0].info["energy"],
                                               ours[1].info["energy"]]


LOG = """LAMMPS (test)
units metal
Step Temp PotEng TotEng Press
       0          300   -17.5   -17.2    1000.5
      10    290.5   -17.45   -17.15    990.25
Loop time of 0.1 on 1 procs for 10 steps with 2 atoms

run 10
Step Temp PotEng TotEng Press
      10    290.5   -17.45   -17.15    990.25
      20    280.25   -17.4   -17.1    980.0
Loop time of 0.1 on 1 procs for 10 steps with 2 atoms
"""


def _dump(path):
    frames = []
    for i, step in enumerate((0, 10, 20, 30)):
        frames.append(
            f"ITEM: TIMESTEP\n{step}\nITEM: NUMBER OF ATOMS\n2\n"
            "ITEM: BOX BOUNDS xy xz yz pp pp pp\n"
            f"0.0 3.2 0.1\n0.0 3.1 0.0\n0.0 3.0 0.0\n"
            "ITEM: ATOMS id type x y z fx fy fz\n"
            f"2 1 1.6 1.5 {1.5 + 0.01 * i} -0.1 0.2 0.3\n"
            f"1 1 0.0 0.0 {0.01 * i} 0.1 -0.2 -0.3\n")
    with open(path, "w") as f:
        f.write("".join(frames))


def test_lammps_readers(tmp_path):
    with open(tmp_path / "log.lammps", "w") as f:
        f.write(LOG)
    _dump(str(tmp_path / "dump.lammpstrj"))
    log = io.parse_lammps_log(str(tmp_path / "log.lammps"))
    ref_log = j_io.parse_lammps_log(str(tmp_path / "log.lammps"))
    assert list(log) == list(ref_log.columns)
    for name in log:
        assert np.array_equal(log[name], ref_log[name].to_numpy())
    assert list(log["Step"]) == [0, 10, 20]
    steps, frames = io.parse_lammps_dump(str(tmp_path / "dump.lammpstrj"),
                                         {1: "W"}, timesteps=[10, 20])
    ref_series = j_io.parse_lammps_dump(str(tmp_path / "dump.lammpstrj"),
                                        {1: "W"}, timesteps=[10, 20])
    assert steps == list(ref_series.index) == [10, 20]
    for a, b in zip(frames, ref_series.values):
        _same_atoms(a, b)
        assert a.get_chemical_symbols() == ["W", "W"]
        for c in ("fx", "fy", "fz"):
            assert np.array_equal(a.arrays[c], b.arrays[c])
        assert np.array_equal(a.info["celldisp"], b.info["celldisp"])
    ours = io.parse_lammps_outputs(str(tmp_path), {1: "W"})
    ref = j_io.parse_lammps_outputs(str(tmp_path), {1: "W"})
    assert len(ours) == len(ref) == 3
    for geom, (_, row) in zip(ours, ref.iterrows()):
        _same_atoms(geom, row["geometry"])
        assert geom.info["energy"] == row["energy"]
        assert geom.info["Step"] == row["Step"]
        assert geom.info["Press"] == row["Press"]
        assert np.array_equal(geom.arrays["fx"], row["fx"])


# -- the ASE adapter without ase -------------------------------------------
class TestAseAdapter:
    def test_import_without_ase(self):
        assert hasattr(ase_adapter, "UFAseCalculator")
        if not ase_adapter.HAVE_ASE:
            model = ls.WeightedLinearModel.from_json(MODEL, device="cpu")
            with pytest.raises(ImportError):
                ase_adapter.UFAseCalculator(model, device="cpu")
            with pytest.raises(ImportError):
                ase_adapter.to_ase(bulk("W", "bcc", a=3.16))

    def test_from_ase_duck_typed(self):
        """from_ase takes anything with the ase accessor quartet,
        uf3_tpu's Atoms among them."""
        geom = j_atoms.bulk("W", "bcc", a=3.16) * 2
        converted = ase_adapter.from_ase(geom)
        assert isinstance(converted, Atoms)
        _same_atoms(converted, geom)


# -- plots ------------------------------------------------------------------
@pytest.fixture(scope="module")
def w_models():
    return (ls.WeightedLinearModel.from_json(MODEL, device="cpu"),
            j_ls.WeightedLinearModel.from_json(MODEL))


def test_cubehelix_and_cmaps():
    rgb = p3.cubehelix(256)
    assert np.array_equal(rgb, j_p3.cubehelix(256))
    lum = rgb @ np.array([0.299, 0.587, 0.114])
    assert np.all(np.diff(lum) > -1e-6)
    rain = p3.perceptual_rainbow_cmap()
    assert p3.cubehelix_cmap()(0.5) != rain(0.5)
    assert rain(0.5) == j_p3.perceptual_rainbow_cmap()(0.5)


def test_marching_tetrahedra_sphere():
    ax = np.linspace(-1.5, 1.5, 40)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    values = np.sqrt(x ** 2 + y ** 2 + z ** 2)
    verts, tris = p3.marching_tetrahedra(values, 1.0, coords=(ax, ax, ax))
    ref_verts, ref_tris = j_p3.marching_tetrahedra(values, 1.0,
                                                   coords=(ax, ax, ax))
    assert np.array_equal(tris, ref_tris)
    assert np.array_equal(verts, ref_verts)
    assert np.abs(np.linalg.norm(verts, axis=1) - 1.0).max() < 0.01
    empty = p3.marching_tetrahedra(np.zeros((5, 5, 5)), 1.0)
    assert len(empty[0]) == 0 and len(empty[1]) == 0


def test_volume_plotter_and_slices(w_models):
    import matplotlib.pyplot as plt
    ours, ref = w_models
    pl = p3.ThreeBodyVolumePlotter(ours)
    ref_pl = j_p3.ThreeBodyVolumePlotter(ref)
    values = pl.sample_uniformly(10)
    assert np.array_equal(values, ref_pl.sample_uniformly(10))
    theta = pl.sample_uniformly(12, theta=True)
    assert np.array_equal(theta, ref_pl.sample_uniformly(12, theta=True))
    assert pl.plot_isosurface(n_samples=14) is not None
    assert pl.plot_volume(n_samples=10, theta=True) is not None
    fig, axes = pl.plot_slices(n_panels=4, n=24)
    assert len(axes) == 4
    plt.close("all")
