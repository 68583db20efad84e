"""
The port's data side of the fit (``uf3_tpu_torch/data/io.py``'s
``DataCoordinator``, ``parse_with_subsampling``, ``read_vasp_pressure``,
``filter_max_forces`` and the ase.db cache; ``BasisFeaturizer.evaluate``;
``fit_from_file`` / ``batched_predict`` over the ``.npz`` features; the
``featurize`` / ``fit`` / ``predict`` commands) on the CPU in float64,
against ``uf3_tpu`` on the same inputs:

- the twins of ``tests/test_io.py``'s coordinator, force filter and
  cache tests: keys, energies, sizes and forces equal, the ``.db``
  files of both packages read by the other bit for bit;
- the twins of ``test_fit_from_file_roundtrip`` and of
  ``test_full_pipeline_tungsten`` on strained and rattled bcc W 2^3
  cells labeled by the repo's W potential: the port's ``.npz`` fit
  predicts within 1e-8 relative of ``uf3_tpu``'s ``fit_from_file`` on
  its HDF5 tables (subset, sample weights, dropped columns);
- ``dataframe_to_tuples`` and the ``.npz`` rows within 1e-12 of the
  reference's ``dataframe_to_tuples``, and ``fit_from_file_sharded``
  equal to ``fit_from_file``;
- the settings' ``data.keys`` and ``data.vasp_pressure`` through both
  packages' ``featurize`` commands, a ``.db`` source, and
  ``read_vasp_pressure``'s sign and comments against ``uf3_tpu``'s
  (ROADMAP.md section 3).
"""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from uf3_tpu import __main__ as j_main
from uf3_tpu.data import io as j_io
from uf3_tpu.data.atoms import Atoms as JAtoms
from uf3_tpu.data.composition import ChemicalSystem as JChem
from uf3_tpu.regression import least_squares as jls
from uf3_tpu.representation import process as j_process
from uf3_tpu.representation.basis import BSplineBasis as JBasis
from uf3_tpu_torch.__main__ import main
from uf3_tpu_torch.data import io
from uf3_tpu_torch.data.atoms import Atoms, bulk
from uf3_tpu_torch.data.composition import ChemicalSystem
from uf3_tpu_torch.examples.nexe_pair_fit import write_lammps_run
from uf3_tpu_torch.forcefield.calculator import UFCalculator
from uf3_tpu_torch.ops import featurize as tf
from uf3_tpu_torch.parallel import mesh as pmesh
from uf3_tpu_torch.regression import least_squares as ls
from uf3_tpu_torch.representation.basis import BSplineBasis
from uf3_tpu_torch.representation.process import BasisFeaturizer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "benchmarks_data", "model_2and3.json")
FIT_TOL = 1e-8       # fitted energies and forces, relative
ROW_TOL = 1e-12      # feature rows of the same configurations
# 3-body legs of half the pair cutoff: the reference's ghost supercell
# (built at the cutoff) then holds every leg, so both packages' host
# featurizers see the same neighbors (ROADMAP.md section 3)
SMALL = dict(
    r_min_map={("W", "W"): 1.5, ("W", "W", "W"): [1.5] * 3},
    r_max_map={("W", "W"): 6.0, ("W", "W", "W"): [3.0, 3.0, 6.0]},
    resolution_map={("W", "W"): 8, ("W", "W", "W"): [4, 4, 8]})
REG = dict(c2=1e-8, c3=1e-8)


def kbar(pressure):
    """``pressure`` in kbar as eV/A^3, in the reference's arithmetic."""
    return pressure * 1e-22 / 1.602176634e-19


def small_bases():
    return (JBasis(JChem(["W"], degree=3), **SMALL),
            BSplineBasis(ChemicalSystem(["W"], degree=3), **SMALL))


@pytest.fixture(scope="module")
def frames():
    """Ten bcc W 2^3 cells (16 atoms), strained within +-2% and rattled
    by 0.03-0.1 A, labeled with energies and forces by the repo's W
    potential in float64."""
    rng = np.random.RandomState(7)
    calc = UFCalculator(MODEL, device="cpu")
    out = []
    for _ in range(10):
        geom = bulk("W", "bcc", a=3.1652) * 2
        geom.set_cell(geom.get_cell() * (1.0 + rng.uniform(-0.02, 0.02)),
                      scale_atoms=True)
        geom.rattle(rng.uniform(0.03, 0.1), seed=int(rng.randint(2 ** 31)))
        geom.info["energy"] = float(calc.get_potential_energy(geom))
        forces = np.asarray(calc.get_forces(geom))
        for c, name in enumerate(("fx", "fy", "fz")):
            geom.arrays[name] = forces[:, c].copy()
        out.append(geom)
    return out


def write_sources(root, frames, split=5):
    """The frames as two extended-xyz sources, ``a/train.xyz`` and
    ``b/train.xyz``; returns their paths."""
    paths = []
    for name, part in (("a", frames[:split]), ("b", frames[split:])):
        os.makedirs(os.path.join(root, name), exist_ok=True)
        paths.append(os.path.join(root, name, "train.xyz"))
        io.write_xyz(paths[-1], part)
    return paths


def assert_same_dataset(ours, ref, energy_key="energy"):
    """A port ``Dataset`` and a reference DataFrame: keys, energies,
    sizes and forces equal, positions and cells bit-equal."""
    assert ours.keys == list(ref.index)
    assert np.array_equal(np.asarray(ours[energy_key], dtype=float),
                          ref[energy_key].to_numpy(dtype=float),
                          equal_nan=True)
    assert list(ours["size"]) == list(ref["size"])
    for c in ("fx", "fy", "fz"):
        for a, b in zip(ours[c], ref[c]):
            # a missing component: None in the port, NaN in a DataFrame
            assert np.array_equal(a, b) if a is not None \
                else np.isscalar(b) and np.isnan(b)
    for a, b in zip(ours["geometry"], ref["geometry"]):
        assert np.array_equal(a.positions, b.positions)
        assert np.array_equal(a.get_cell(), np.asarray(b.get_cell()))


# -- the coordinator (tests/test_io.py:94-141) ------------------------------
def _lists(n=3, seed=0):
    rng = np.random.RandomState(seed)
    positions = [rng.rand(2, 3) * 3 + 1 for _ in range(n)]
    energies = rng.rand(n).tolist()
    forces = [rng.rand(2, 3) for _ in range(n)]
    return positions, energies, forces


def _both_coordinators(calls):
    """``calls(coordinator, make_atoms)`` on a coordinator of each
    package; returns (port, reference)."""
    ours, ref = io.DataCoordinator(), j_io.DataCoordinator()
    calls(ours, lambda x: Atoms([74] * len(x), x, pbc=False))
    calls(ref, lambda x: JAtoms("W%d" % len(x), positions=x))
    return ours, ref


class TestDataCoordinator:
    def test_from_lists_and_consolidate(self):
        def calls(coordinator, make):
            for prefix, seed in (("a", 0), ("b", 1)):
                positions, energies, forces = _lists(seed=seed)
                coordinator.dataframe_from_lists(
                    [make(x) for x in positions], prefix=prefix,
                    energies=energies, forces=forces)
        ours, ref = _both_coordinators(calls)
        df, df_ref = ours.consolidate(), ref.consolidate()
        assert len(df) == len(df_ref) == 6
        assert df.keys[0] == "a_0" and df["size"][0] == 2
        assert_same_dataset(df, df_ref)
        assert repr(ours) == repr(ref)

    def test_prefix_conflict_skips(self, capsys):
        def calls(coordinator, make):
            positions, energies, forces = _lists()
            for _ in range(2):
                coordinator.dataframe_from_lists(
                    [make(x) for x in positions], prefix="a",
                    energies=energies, forces=forces)
        ours, ref = _both_coordinators(calls)
        assert ours.keys == ref.keys == ["a"]
        said = capsys.readouterr().out.splitlines()
        assert said[0] == said[1] == 'Data already exists with prefix "a". ' \
            'Skipping...'

    @pytest.mark.parametrize("keep", ["first", "last", False])
    def test_overwrite_and_duplicates(self, keep, capsys):
        """``overwrite`` replaces a prefix's rows; ``consolidate`` drops
        repeated keys as ``keep`` says, and counts them aloud."""
        def calls(coordinator, make):
            coordinator.overwrite = True
            for seed in (0, 1):
                positions, energies, forces = _lists(seed=seed)
                coordinator.dataframe_from_lists(
                    [make(x) for x in positions], prefix="a",
                    energies=energies, forces=forces)
            positions, energies, _ = _lists(n=2, seed=2)
            df = coordinator.dataframe_from_lists(
                [make(x) for x in positions], prefix="a", energies=energies,
                load=False)
            coordinator.overwrite = False
            coordinator.data["c"] = df   # the keys "a_0", "a_1" again
            coordinator.keys.append("c")
        ours, ref = _both_coordinators(calls)
        df = ours.consolidate(keep=keep)
        df_ref = ref.consolidate(keep=keep)
        assert_same_dataset(df, df_ref)
        said = capsys.readouterr().out
        assert said.count("Duplicates keys found:") == 2
        kept = ours.consolidate(remove_duplicates=False)
        assert len(kept) == 5

    def test_subsampling_parse(self, tmp_path):
        """Per-file farthest-point subsampling: the same configurations
        kept (tests/test_io.py:127-141)."""
        positions, _, forces = _lists(n=10)
        rng = np.random.RandomState(3)
        geoms = []
        for x, force in zip(positions, forces):
            geom = Atoms([74, 74], x, pbc=False)
            geom.info["energy"] = float(rng.rand())
            for c, name in enumerate(("fx", "fy", "fz")):
                geom.arrays[name] = force[:, c]
            geoms.append(geom)
        path = str(tmp_path / "traj.xyz")
        io.write_xyz(path, geoms)
        ours, ref = io.DataCoordinator(), j_io.DataCoordinator()
        io.parse_with_subsampling([path], ours, max_samples=5,
                                  min_diff=1e-6)
        j_io.parse_with_subsampling([path], ref, max_samples=5,
                                    min_diff=1e-6)
        df = ours.consolidate()
        assert 1 <= len(df) <= 5
        assert_same_dataset(df, ref.consolidate())

    def test_trajectory_sources_and_custom_keys(self, tmp_path, frames):
        """``parse_with_subsampling`` over two directories with the
        coordinator's own energy key (read through the Python parser, as
        the reference rules) equal to ``uf3_tpu``'s; the default keys
        through the native tokenizer too."""
        paths = write_sources(str(tmp_path), frames)
        for path in paths:
            with open(path) as f:
                text = f.read()
            with open(path, "w") as f:   # free_energy = energy - 1.5
                f.write("\n".join(
                    line + f" free_energy={float(line.split('energy=')[1]) - 1.5!r}"
                    if "energy=" in line else line
                    for line in text.splitlines()) + "\n")
        for keys in ({}, {"energy_key": "free_energy"}):
            ours = io.DataCoordinator.from_config(keys)
            ref = j_io.DataCoordinator.from_config(keys)
            io.parse_with_subsampling(paths, ours, max_samples=-1)
            j_io.parse_with_subsampling(paths, ref, max_samples=-1)
            df = ours.consolidate()
            assert df.keys[0] == "a-train.xyz_0" and len(df) == 10
            assert_same_dataset(df, ref.consolidate(),
                                energy_key=ours.energy_key)
        assert np.allclose(df["free_energy"],
                           [g.info["energy"] - 1.5 for g in frames],
                           rtol=0, atol=1e-9)

    def test_lammps_source(self, tmp_path, frames):
        """``parse_with_subsampling`` of a LAMMPS run (dump beside its
        log, TotEng as the energy): keys from the log's rows, energies,
        sizes and forces equal to ``uf3_tpu``'s."""
        run = str(tmp_path / "run")
        write_lammps_run(run, frames[:4], aliases={1: "W"})
        dump = os.path.join(run, "dump.lammpstrj")
        ours, ref = io.DataCoordinator(), j_io.DataCoordinator()
        for coordinator, package in ((ours, io), (ref, j_io)):
            package.parse_with_subsampling(
                [dump], coordinator, max_samples=-1, lammps_log="log.lammps",
                lammps_aliases={1: "W"}, vasp_pressure=True)
        df, df_ref = ours.consolidate(), ref.consolidate()
        assert df.keys == list(df_ref.index) == [
            f"dump.lammpstrj_{i}" for i in range(4)]
        # pandas' own float parser reads the run within an ulp
        assert np.allclose(df["energy"], df_ref["energy"].to_numpy(),
                           rtol=1e-15, atol=0)
        assert np.array_equal(df["Step"], df_ref["Step"].to_numpy())
        assert list(df["size"]) == list(df_ref["size"]) == [16] * 4
        for c in ("fx", "fy", "fz"):
            for a, b in zip(df[c], df_ref[c]):
                assert np.allclose(a, b, rtol=1e-15, atol=1e-15)


# -- force filtering (tests/test_io.py:143-151) ------------------------------
def test_filter_max_forces(frames):
    df = pd.DataFrame({
        "fx": [np.array([0.1, 0.2]), np.array([100.0, 0.0])],
        "fy": [np.array([0.0, 0.0]), np.array([0.0, 0.0])],
        "fz": [np.array([0.0, 0.0]), np.array([0.0, 0.0])]},
        index=["ok", "bad"])
    dataset = io.Dataset(["ok", "bad"], {c: list(df[c]) for c in df})
    assert io.filter_max_forces(dataset, cutoff=10) \
        == list(j_io.filter_max_forces(df, cutoff=10)) == ["ok"]
    # the labeled cells, cut at their median largest force, with the
    # values
    ours = io.prepare_dataframe_from_lists(frames, prefix="w")
    ref = j_io.prepare_dataframe_from_lists(
        [JAtoms(numbers=g.numbers, positions=g.positions, cell=g.cell,
                pbc=True) for g in frames], prefix="w",
        energies=[g.info["energy"] for g in frames],
        forces=[np.stack([g.arrays[c] for c in ("fx", "fy", "fz")], 1)
                for g in frames])
    _, values = io.filter_max_forces(ours, cutoff=np.inf,
                                     return_values=True)
    cutoff = float(np.median(values))
    kept, values = io.filter_max_forces(ours, cutoff=cutoff,
                                        return_values=True)
    kept_ref, values_ref = j_io.filter_max_forces(ref, cutoff=cutoff,
                                                  return_values=True)
    assert kept == list(kept_ref) and 0 < len(kept) < 10
    assert np.array_equal(values, values_ref.to_numpy(dtype=float))
    assert kept == [k for k, g in zip(ours.keys, frames)
                    if np.linalg.norm(np.stack([g.arrays[c] for c in (
                        "fx", "fy", "fz")], 1), axis=1).max() <= cutoff]
    # a configuration without forces is dropped (the reference's
    # get_max_forces cannot stack a NaN beside the other components);
    # a list of configurations is keyed by position
    geoms = [g.copy() for g in frames]
    del geoms[int(kept[0].split("_")[1])].arrays["fx"]
    assert io.filter_max_forces(geoms, cutoff=cutoff) \
        == [int(k.split("_")[1]) for k in kept[1:]]


# -- the ase.db cache (tests/test_io.py:154-200) -----------------------------
def _assert_same_geometries(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert np.array_equal(a.get_atomic_numbers(), b.get_atomic_numbers())
        assert np.array_equal(a.positions, b.positions)
        assert np.array_equal(np.asarray(a.get_cell()),
                              np.asarray(b.get_cell()))
        assert np.array_equal(a.get_pbc(), b.get_pbc())
        assert a.info == b.info
        for c in ("fx", "fy", "fz"):
            assert np.array_equal(a.arrays[c], b.arrays[c])


def test_cache_and_read_roundtrip_both_ways(tmp_path, frames):
    """Each package's ``cache_data`` read by both ``read_database``s bit
    for bit: positions, cells, numbers, energies, forces, row names;
    the ``.db`` file loads back through ``parse_trajectory``."""
    paths = write_sources(str(tmp_path / "data"), frames)
    ours, ref = io.DataCoordinator(), j_io.DataCoordinator()
    ours.dataframe_from_trajectory(paths[0], prefix="dft")
    ref.dataframe_from_trajectory(paths[0], prefix="dft")
    df, df_ref = ours.consolidate(), ref.consolidate()
    db_ours, db_ref = str(tmp_path / "ours.db"), str(tmp_path / "ref.db")
    io.cache_data(df, db_ours)
    j_io.cache_data(df_ref, db_ref)
    for path in (db_ours, db_ref):
        read = io.read_database(path)
        _assert_same_geometries(read, j_io.read_database(path))
        assert [g.info["row_name"] for g in read] == df.keys
        for geom, source in zip(read, df["geometry"]):
            assert np.array_equal(geom.positions, source.positions)
            assert geom.info["energy"] == source.info["energy"]
            assert np.array_equal(geom.arrays["fx"], source.arrays["fx"])
    df_db = io.parse_trajectory(db_ours, prefix="db")
    assert np.array_equal(df_db["energy"], df["energy"])
    assert df_db.keys == [f"db_{i}" for i in range(5)]


def test_read_database_slicing(tmp_path):
    geoms = []
    for i in range(4):
        g = Atoms([74, 74], np.random.RandomState(i).rand(2, 3),
                  cell=np.eye(3) * 4.0, pbc=True)
        g.info["energy"] = float(i)
        for c in ("fx", "fy", "fz"):
            g.arrays[c] = np.zeros(2)
        geoms.append(g)
    df = io.prepare_dataframe_from_lists(
        geoms, energies=[g.info["energy"] for g in geoms])
    assert df.keys == [0, 1, 2, 3]
    db_path = str(tmp_path / "slice.db")
    io.cache_data(df, db_path)
    for package in (io, j_io):
        subset = package.read_database(db_path, index=slice(1, 3))
        assert len(subset) == 2
        assert subset[0].info["energy"] == 1.0
        assert subset[1].info["row_name"] == "2"
    assert io.read_database(db_path, index=slice(2, 2)) == []


def test_db_source_is_read(tmp_path, frames):
    """A ``.db`` source goes through ``read_database``: ``read_sources``
    keeps its configurations where it used to hand the file to the
    extended-xyz reader and drop it."""
    db = str(tmp_path / "cache.db")
    io.cache_data(io.prepare_dataframe_from_lists(frames[:3], prefix="w"),
                  db)
    xyz = write_sources(str(tmp_path / "data"), frames[3:])[0]
    keys, geoms = io.read_sources([db, xyz])
    assert keys[:3] == ["cache.db_0", "cache.db_1", "cache.db_2"]
    assert len(keys) == 3 + 5
    _assert_same_geometries(geoms[:3], j_io.read_database(db))
    assert [g.info["energy"] for g in geoms[:3]] \
        == [g.info["energy"] for g in frames[:3]]


# -- VASP pressure ---------------------------------------------------------
@pytest.mark.parametrize("line, ours_kbar, ref_kbar", [
    ("PSTRESS = 25.0", 25.0, 25.0),
    ("   PSTRESS=    12.50 pullay stress", 12.5, 12.5),
    ("PSTRESS = -5.0", -5.0, 5.0),                    # the sign dropped
    ("PSTRESS = 10 ! 2.5 kB", 10.0, 102.5),           # a comment's digits
])
def test_read_vasp_pressure(tmp_path, line, ours_kbar, ref_kbar):
    """The port reads PSTRESS with its sign and without a trailing
    comment's digits; where the line is plain and positive it equals
    ``uf3_tpu``'s, elsewhere ``uf3_tpu`` misreads it (ROADMAP.md
    section 3)."""
    (tmp_path / "INCAR").write_text(f"ENCUT = 500\n{line}\nISIF = 3\n")
    assert io.read_vasp_pressure(str(tmp_path)) == kbar(ours_kbar)
    assert j_io.read_vasp_pressure(str(tmp_path)) == kbar(ref_kbar)


def test_read_vasp_pressure_files(tmp_path):
    """No file: 0; a commented-out tag is skipped; vasprun.xml's entry
    read with its sign where INCAR and OUTCAR set none."""
    assert io.read_vasp_pressure(str(tmp_path)) == 0.0
    (tmp_path / "INCAR").write_text("# PSTRESS = 40\nENCUT = 500\n")
    (tmp_path / "vasprun.xml").write_text(
        '<i name="PSTRESS">     -7.50000000</i>\n')
    assert io.read_vasp_pressure(str(tmp_path)) == kbar(-7.5)


# -- the feature table and the .npz fit ----------------------------------------
def _dimer_rows(featurizer, n=4):
    """tests/test_least_squares.py:122-152's W dimers: the reference's
    ``evaluate_configuration`` rows."""
    rng = np.random.RandomState(0)
    rows = {}
    for i in range(n):
        geom = JAtoms("W2", positions=[[0, 0, 0], [2.2 + 0.3 * i, 0, 0]],
                      pbc=False)
        rows.update(featurizer.evaluate_configuration(
            geom, name=f"0_{i}", energy=-1.0 + 0.1 * i,
            forces=rng.normal(size=(3, 2)) * 0.1))
    df = pd.DataFrame.from_dict(rows, orient="index",
                                columns=featurizer.columns)
    df.index = pd.MultiIndex.from_tuples(df.index)
    return df


def test_fit_from_file_roundtrip(tmp_path):
    """The twin of ``test_fit_from_file_roundtrip``: the dimers' rows
    as ``featurize`` stores them, fitted from the ``.npz`` and from
    ``uf3_tpu``'s HDF5 table and predicted back, against ``uf3_tpu``'s
    fit of that table."""
    pair = dict(r_min_map={("W", "W"): 1.5}, r_max_map={("W", "W"): 5.5},
                resolution_map={("W", "W"): 12})
    j_basis = JBasis(JChem(["W"]), **pair)
    basis = BSplineBasis(ChemicalSystem(["W"]), **pair)
    df = _dimer_rows(j_process.BasisFeaturizer(j_basis))
    h5 = str(tmp_path / "features.h5")
    j_process.save_feature_db(df, h5, table_name="features_000")
    npz = str(tmp_path / "features.npz")
    x_e, y_e, x_f, y_f = jls.dataframe_to_tuples(df, n_elements=1)
    with open(npz, "wb") as f:
        np.savez(f, x_e=x_e, y_e=y_e, x_f=x_f, y_f=y_f,
                 keys=np.array([f"0_{i}" for i in range(4)]),
                 sizes=np.full(4, 2), force_rows=np.full(4, 6),
                 columns=np.array(list(df.columns)))
    keys = [f"0_{i}" for i in range(4)]
    ref = jls.WeightedLinearModel(j_basis, r2=1e-6, c2=1e-6)
    ref.fit_from_file(h5, subset=keys)
    model = ls.WeightedLinearModel(basis, r2=1e-6, c2=1e-6, device="cpu")
    model.fit_from_file(npz, subset=keys)
    assert np.all(np.isfinite(model.coefficients))
    y_e, p_e, y_f, p_f = model.batched_predict(npz, score=False)
    r_e, q_e, r_f, q_f = ref.batched_predict(h5, score=False)
    assert len(y_e) == 4 and len(y_f) == 4 * 6
    assert np.array_equal(y_e, r_e) and np.array_equal(y_f, r_f)
    assert np.abs(p_e - q_e).max() <= FIT_TOL * np.abs(q_e).max()
    assert np.abs(p_f - q_f).max() <= FIT_TOL * np.abs(q_f).max()
    # the reference's HDF5 table read by the port: the .npz fit's
    # predictions within 1e-10, the reference's within FIT_TOL
    from_h5 = ls.WeightedLinearModel(basis, r2=1e-6, c2=1e-6, device="cpu")
    from_h5.fit_from_file(h5, subset=keys)
    h_e, s_e, h_f, s_f = from_h5.batched_predict(h5, score=False)
    assert np.array_equal(h_e, r_e) and np.array_equal(h_f, r_f)
    assert np.abs(s_e - p_e).max() <= 1e-10 * np.abs(p_e).max()
    assert np.abs(s_f - p_f).max() <= 1e-10 * np.abs(p_f).max()
    assert np.abs(s_e - q_e).max() <= FIT_TOL * np.abs(q_e).max()
    assert np.abs(s_f - q_f).max() <= FIT_TOL * np.abs(q_f).max()
    with pytest.raises(ValueError, match="one energy column"):
        model.fit_from_file(npz, subset=keys, energy_key="free_energy")
    with pytest.raises(KeyError, match="WW99"):
        model.fit_from_file(npz, subset=keys, drop_columns=["WW99"])


@pytest.fixture(scope="module")
def pipeline(frames, tmp_path_factory):
    """``test_full_pipeline_tungsten`` in both packages on the labeled
    cells: coordinator -> consolidate -> features (``uf3_tpu``: HDF5
    tables of 3 configurations; the port: ``Featurizer.write_features``'s
    ``.npz`` on the CPU) and the feature tables of ``evaluate``."""
    root = tmp_path_factory.mktemp("pipeline")
    paths = write_sources(str(root / "data"), frames)
    ours, ref = io.DataCoordinator(), j_io.DataCoordinator()
    io.parse_with_subsampling(paths, ours, max_samples=-1)
    j_io.parse_with_subsampling(paths, ref, max_samples=-1)
    df, df_ref = ours.consolidate(), ref.consolidate()
    j_basis, basis = small_bases()
    h5, npz = str(root / "features.h5"), str(root / "features.npz")
    j_featurizer = j_process.BasisFeaturizer(j_basis)
    j_featurizer.batched_to_hdf(h5, df_ref, batch_size=3)
    featurizer = tf.Featurizer(basis, device="cpu")
    featurizer.write_features(npz, df)
    table = BasisFeaturizer(basis).evaluate(df)
    table_ref = j_featurizer.evaluate(df_ref)
    return dict(df=df, df_ref=df_ref, bases=(j_basis, basis), h5=h5,
                npz=npz, table=table, table_ref=table_ref,
                route=featurizer.route)


def test_evaluate_matches_reference_table(pipeline):
    """``BasisFeaturizer.evaluate``'s table: the reference DataFrame's
    row index, column names and values (1e-12)."""
    table, ref = pipeline["table"], pipeline["table_ref"]
    assert table.index == list(ref.index)
    assert table.columns == list(ref.columns)
    assert len(table) == 10 * (1 + 3 * 16)
    assert np.abs(table.to_numpy() - ref.to_numpy()).max() \
        <= ROW_TOL * np.abs(ref.to_numpy()).max()


def test_dataframe_to_tuples_weights_and_drop_columns(pipeline):
    """``dataframe_to_tuples`` on the port's table with per-atom
    normalization and sample weights, and the ``.npz`` rows with the
    same weights and dropped columns, against the reference's
    ``dataframe_to_tuples`` (1e-12)."""
    df = pipeline["df"]
    weights = {key: 0.5 + 0.1 * i for i, key in enumerate(df.keys)
               if i % 3}
    ref = jls.dataframe_to_tuples(pipeline["table_ref"], n_elements=1,
                                  sample_weights=weights)
    ours = ls.dataframe_to_tuples(pipeline["table"], n_elements=1,
                                  sample_weights=weights)
    drop = ["WW1", "WWW3"]
    ref_drop = jls.dataframe_to_tuples(
        pipeline["table_ref"].drop(columns=drop), n_elements=1,
        sample_weights=weights)
    rows = ls.feature_rows(pipeline["npz"], sample_weights=weights,
                           drop_columns=drop)
    for a, b, c, d in zip(ours, ref, rows, ref_drop):
        assert a.shape == b.shape and c.shape == d.shape
        scale = max(np.abs(b).max(), 1.0)
        assert np.abs(a - b).max() <= ROW_TOL * scale
        assert np.abs(c - d).max() <= ROW_TOL * scale
    subset = df.keys[2:5]
    sub = ls.feature_rows(pipeline["npz"], subset=subset)
    ref_sub = jls.dataframe_to_tuples(
        pipeline["table_ref"].loc[subset], n_elements=1)
    for a, b in zip(sub, ref_sub):
        assert np.abs(a - b).max() <= ROW_TOL * max(np.abs(b).max(), 1.0)


def _probe(npz):
    x_e, _, x_f, _ = ls.feature_rows(npz)
    return x_e, x_f


def _assert_same_fit(coefficients, ref_coefficients, npz):
    """Energies and forces of both fits on every row, within
    ``FIT_TOL`` relative."""
    for x in _probe(npz):
        want = x @ ref_coefficients
        assert np.abs(x @ coefficients - want).max() \
            <= FIT_TOL * np.abs(want).max()


def test_full_pipeline_tungsten(pipeline):
    """The twin of ``test_full_pipeline_tungsten``: ``fit_from_file`` on
    8 of the 10 configurations (the ``.npz``) against ``uf3_tpu``'s on
    its HDF5 tables, fitted energies and forces within 1e-8 relative;
    ``batched_predict`` on every key with small training errors; the
    model's JSON round trip."""
    j_basis, basis = pipeline["bases"]
    keys = pipeline["df"].keys
    assert pipeline["route"] == "device"
    ref = jls.WeightedLinearModel(j_basis, **REG)
    ref.fit_from_file(pipeline["h5"], subset=keys[:8], weight=0.5)
    model = ls.WeightedLinearModel(basis, device="cpu", **REG)
    model.fit_from_file(pipeline["npz"], subset=keys[:8], weight=0.5)
    _assert_same_fit(model.coefficients, ref.coefficients, pipeline["npz"])
    y_e, p_e, y_f, p_f, rmse_e, rmse_f = model.batched_predict(
        pipeline["npz"], keys=keys)
    r_e, q_e, r_f, q_f = ref.batched_predict(pipeline["h5"], keys=keys,
                                             score=False)
    assert len(y_e) == 10 and len(y_f) == 10 * 48
    assert np.abs(y_e - r_e).max() <= ROW_TOL * np.abs(r_e).max()
    assert np.abs(p_f - q_f).max() <= FIT_TOL * np.abs(q_f).max()
    assert rmse_e * 1000 < 5.0 and rmse_f < 0.2
    held = model.batched_predict(pipeline["npz"], keys=keys[8:],
                                 score=False)
    assert len(held[0]) == 2 and len(held[2]) == 2 * 48


def test_fit_from_file_weights_subset_and_drop(pipeline):
    """``fit_from_file`` with sample weights, a subset, a batch size
    below the row count and dropped columns against ``uf3_tpu``'s."""
    j_basis, basis = pipeline["bases"]
    keys = pipeline["df"].keys
    weights = {k: 1.0 + 0.3 * (i % 4) for i, k in enumerate(keys)}
    ref = jls.WeightedLinearModel(j_basis, **REG)
    ref.fit_from_file(pipeline["h5"], subset=keys[1:], weight=0.3,
                      sample_weights=weights, batch_size=100)
    model = ls.WeightedLinearModel(basis, device="cpu", **REG)
    model.fit_from_file(pipeline["npz"], subset=keys[1:], weight=0.3,
                        sample_weights=weights, batch_size=100)
    _assert_same_fit(model.coefficients, ref.coefficients, pipeline["npz"])
    # the 2-body-only columns of a 2-body basis of the same pair knots
    pair = {k: {p: v[p] for p in v if len(p) == 2} for k, v in SMALL.items()}
    j_pair = JBasis(JChem(["W"]), **pair)
    drop = [c for c in pipeline["table"].columns if c.startswith("WWW")]
    ref = jls.WeightedLinearModel(j_pair, **REG)
    ref.fit_from_file(pipeline["h5"], subset=keys, drop_columns=drop)
    model = ls.WeightedLinearModel(BSplineBasis(ChemicalSystem(["W"]), **pair),
                                   device="cpu", **REG)
    model.fit_from_file(pipeline["npz"], subset=keys, drop_columns=drop)
    x_e, _, x_f, _ = ls.feature_rows(pipeline["npz"], drop_columns=drop)
    for x in (x_e, x_f):
        want = x @ ref.coefficients
        assert np.abs(x @ model.coefficients - want).max() \
            <= FIT_TOL * np.abs(want).max()


def test_fit_from_file_sharded_equals_fit_from_file(pipeline):
    """``fit_from_file_sharded`` selects its rows through the same
    ``feature_rows`` and matches ``fit_from_file`` (1e-10)."""
    _, basis = pipeline["bases"]
    keys = pipeline["df"].keys
    weights = {k: 2.0 for k in keys[:3]}
    model = ls.WeightedLinearModel(basis, device="cpu", **REG)
    model.fit_from_file(pipeline["npz"], subset=keys[:9], weight=0.4,
                        sample_weights=weights)
    sharded = ls.WeightedLinearModel(basis, device="cpu", **REG)
    pmesh.fit_from_file_sharded(sharded, pipeline["npz"], subset=keys[:9],
                                weight=0.4, sample_weights=weights,
                                mesh=pmesh.ShardMesh(4, device="cpu"))
    for x in _probe(pipeline["npz"]):
        want = x @ model.coefficients
        assert np.abs(x @ sharded.coefficients - want).max() \
            <= 1e-10 * np.abs(want).max()


def test_prediction_helpers_and_variance(pipeline):
    """``subset_prediction`` on the tables, ``batched_prediction`` on
    the ``.npz`` and ``update_with_components`` on the datasets against
    ``uf3_tpu``'s."""
    j_basis, basis = pipeline["bases"]
    keys = pipeline["df"].keys
    ref = jls.WeightedLinearModel(j_basis, **REG)
    ref.fit_from_file(pipeline["h5"], subset=keys, weight=0.5)
    model = ls.WeightedLinearModel(basis, device="cpu", **REG)
    model.coefficients = ref.coefficients.copy()
    ours = ls.subset_prediction(pipeline["table"], model,
                                subset_keys=keys[3:6], n_elements=1)
    want = jls.subset_prediction(pipeline["table_ref"], ref,
                                 subset_keys=keys[3:6], n_elements=1)
    for a, b in zip(ours, want):
        assert np.abs(a - b).max() <= ROW_TOL * np.abs(b).max()
    assert ls.subset_prediction(pipeline["table"], model,
                                subset_keys=["nowhere"]) == ([], [], [], [])
    batched = ls.batched_prediction(model, pipeline["npz"],
                                    subset_keys=keys[3:6])
    for a, b in zip(batched, want):
        assert np.abs(a - b).max() <= ROW_TOL * np.abs(b).max()
    recorder, j_recorder = ls.VarianceRecorder(), jls.VarianceRecorder()
    got = recorder.update_with_components(pipeline["df"])
    ref_got = j_recorder.update_with_components(pipeline["df_ref"])
    assert got[2] == ref_got[2] == 10 * 48
    assert np.isclose(got[0], ref_got[0], rtol=0, atol=1e-15)
    assert np.isclose(got[1], ref_got[1], rtol=1e-14)


# -- the settings' data keys and PSTRESS through both featurize commands ----
def _settings(tmp_path, tag, features, data):
    settings = {"elements": ["W"], "degree": 2,
                "data": dict({"sources": {"path": str(tmp_path / "data"),
                                          "pattern": "*.xyz"}}, **data),
                "basis": {"r_min": 1.5, "r_max": 5.5, "resolution": 8},
                "features": {"features_path": str(tmp_path / features),
                             "n_cores": 1},
                "learning": {"features_path": str(tmp_path / features)},
                "model": {"model_path": str(tmp_path / f"model_{tag}.json")}}
    path = tmp_path / f"settings_{tag}.json"
    path.write_text(json.dumps(settings))
    return str(path)


def _h5_rows(path):
    frames = [j_process.load_feature_db(path, table)
              for table in j_process.analyze_hdf_tables(path)[2]]
    return pd.concat(frames)


def test_vasp_pressure_through_featurize(tmp_path, frames):
    """``data.vasp_pressure`` with an INCAR holding PSTRESS beside one
    source: both packages' ``featurize`` commands write the same
    energy rows, that source's shifted by -P V per atom; then ``fit``
    and ``predict`` on the port's."""
    write_sources(str(tmp_path / "data"), frames)
    (tmp_path / "data" / "b" / "INCAR").write_text("PSTRESS = 20.0\n")
    j_main.cmd_featurize(_settings(tmp_path, "ref", "features.h5",
                                   {"vasp_pressure": True}))
    ref = jls.dataframe_to_tuples(_h5_rows(str(tmp_path / "features.h5")),
                                  n_elements=1)
    path = _settings(tmp_path, "port", "features.npz",
                     {"vasp_pressure": True})
    main(["featurize", path, "--device", "cpu"])
    with np.load(str(tmp_path / "features.npz")) as data:
        y_e, sizes, keys = data["y_e"], data["sizes"], data["keys"]
    assert np.abs(y_e - ref[1]).max() <= ROW_TOL * np.abs(ref[1]).max()
    for key, y in zip(keys, y_e):
        source, i = key.split("-train.xyz_")
        geom = frames[int(i) + (5 if source == "b" else 0)]
        shift = y * len(geom) - geom.info["energy"]
        want = -kbar(20.0) * geom.get_volume() if source == "b" else 0.0
        assert abs(shift - want) <= 1e-9
    main(["fit", path, "--device", "cpu"])
    main(["predict", path, "--device", "cpu"])
    assert os.path.isfile(str(tmp_path / "model_port.json"))


def test_energy_key_through_featurize(tmp_path, frames, capsys):
    """``data.keys.energy_key: free_energy``: the port's ``featurize``
    writes each configuration's free energy per atom, the value
    ``uf3_tpu``'s coordinator consolidates from the same settings (a
    decoy ``energy`` beside it is not read).  ``uf3_tpu``'s own
    ``featurize`` command writes no energy row at all with this key
    (its ``batched_to_hdf`` looks for an "energy" column; ROADMAP.md
    section 3)."""
    paths = write_sources(str(tmp_path / "data"), frames)
    for path in paths:
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write("\n".join(
                line.replace("energy=", "free_energy=", 1)
                + f" energy={float(line.split('energy=')[1]) + 3.0!r}"
                if "energy=" in line else line
                for line in text.splitlines()) + "\n")
    data = {"keys": {"energy_key": "free_energy"}, "vasp_pressure": True}
    (tmp_path / "data" / "a" / "INCAR").write_text("PSTRESS = 10.0\n")
    ref_path = _settings(tmp_path, "ref", "features.h5", data)
    from uf3_tpu.util import user_config as j_config
    settings = j_config.read_config(ref_path)
    coordinator = j_config.generate_handlers(settings)["data"]
    j_io.parse_with_subsampling(
        j_io.identify_paths(str(tmp_path / "data"), filename_pattern="*.xyz"),
        coordinator, max_samples=-1, vasp_pressure=True)
    df_ref = coordinator.consolidate()
    path = _settings(tmp_path, "port", "features.npz", data)
    main(["featurize", path, "--device", "cpu"])
    with np.load(str(tmp_path / "features.npz")) as stored:
        y_e, sizes, keys = stored["y_e"], stored["sizes"], stored["keys"]
    want = df_ref["free_energy"].to_numpy(dtype=float)
    order = [list(df_ref.index).index(k) for k in keys]
    assert np.abs(y_e * sizes - want[order]).max() <= ROW_TOL * np.abs(
        want).max()
    volumes = np.array([g.get_volume() for g in frames])
    energies = np.array([g.info["energy"] for g in frames])
    by_key = dict(zip(keys, y_e * sizes))
    for i, key in enumerate(f"{d}-train.xyz_{j}" for d in "ab"
                            for j in range(5)):
        shift = kbar(10.0) * volumes[i] if key.startswith("a") else 0.0
        assert abs(by_key[key] - (energies[i] - shift)) <= 1e-9
    # uf3_tpu's command on the same settings: no energy rows
    j_main.cmd_featurize(ref_path)
    kinds = _h5_rows(str(tmp_path / "features.h5")).index.get_level_values(1)
    assert not any(k in ("energy", "free_energy") for k in kinds)
    assert "features written" in capsys.readouterr().out


def test_settings_data_defaults():
    """The ``data`` defaults carry ``uf3_tpu``'s keys and
    ``vasp_pressure``, and the ``data`` handler is a coordinator of
    those keys."""
    import yaml

    from uf3_tpu_torch.util import user_config
    with open(os.path.join(REPO, "uf3_tpu", "default_options.yaml")) as f:
        j_defaults = yaml.safe_load(f)
    data = user_config.DEFAULT_SETTINGS["data"]
    assert data["keys"] == j_defaults["data"]["keys"]
    assert data["vasp_pressure"] is j_defaults["data"]["vasp_pressure"] \
        is False
    settings = {"data": user_config.type_check(
        {"keys": {"energy_key": "free_energy", "size_key": "n"}}, data)}
    coordinator = user_config.generate_handlers(settings)["data"]
    assert (coordinator.atoms_key, coordinator.energy_key,
            coordinator.force_key, coordinator.size_key) \
        == ("geometry", "free_energy", "forces", "n")
