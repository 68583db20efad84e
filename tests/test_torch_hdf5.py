"""
The HDF5 feature store without h5py (``uf3_tpu_torch/util/hdf5.py`` and
``representation/process.py``'s ``save_feature_db`` /
``load_feature_db`` / ``analyze_hdf_tables`` / ``batched_to_hdf``)
against ``uf3_tpu``'s, which writes through h5py, on the CPU in float64:

- the port reads h5py's files bit for bit: 41 tables (several SNODs at
  the file's K = 4), a 20,000 x 72 table of ~35% non-zeros (768 chunks
  of (1250, 5) under a two-level chunk B-tree, the last column chunks
  partial), an overwritten table, a non-ASCII key, an energy-only
  configuration;
- h5py and ``uf3_tpu``'s ``load_feature_db`` / ``analyze_hdf_tables``
  read the port's files; each package appends to (and replaces a table
  in) the other's file, then both read every table;
- a write cut before its last step leaves every earlier table readable,
  and ``write_features`` resumes it; a superblock of version 3 and a
  shuffle-filtered dataset raise ``ValueError`` naming them;
- ``batched_to_hdf`` on the host route and ``Featurizer.write_features``
  on the device route against ``uf3_tpu``'s ``batched_to_hdf`` (batch
  size 3: the table names, rows and kinds; values within 1e-12 and
  1e-9), and a rerun that adds no table and featurizes nothing;
- ``fit_from_file``, ``batched_predict`` and ``fit_from_file_sharded``
  on ``uf3_tpu``'s tables against its ``fit_from_file`` (sample
  weights, dropped columns, ``energy_key="free_energy"``, a subset
  spanning tables; 1e-8), the ``.h5`` fit against the ``.npz`` fit of
  the same rows (1e-10), and the fit's host memory under
  ``tracemalloc`` (one table at a time);
- the committed fixture ``tests/data/features_ref.h5`` (h5py) and its
  ``.npz`` twin against a fresh run of their generator.

Only ``uf3_tpu.representation.process`` and
``uf3_tpu.regression.least_squares`` run on the reference's side; no
JAX engine is compiled.
"""

import os
import tracemalloc
import warnings

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from uf3_tpu.data.atoms import Atoms as JAtoms
from uf3_tpu.data.composition import ChemicalSystem as JChem
from uf3_tpu.regression import least_squares as jls
from uf3_tpu.representation import process as j_process
from uf3_tpu.representation.basis import BSplineBasis as JBasis
from uf3_tpu_torch import io as model_io
from uf3_tpu_torch.data import io
from uf3_tpu_torch.data.atoms import bulk
from uf3_tpu_torch.data.composition import ChemicalSystem
from uf3_tpu_torch.ops import featurize as tf
from uf3_tpu_torch.parallel import mesh as pmesh
from uf3_tpu_torch.regression import least_squares as ls
from uf3_tpu_torch.representation import process
from uf3_tpu_torch.representation.basis import BSplineBasis
from uf3_tpu_torch.util import hdf5

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "benchmarks_data", "model_2and3.json")
FIXTURE = os.path.join(REPO, "tests", "data", "features_ref")
FIT_TOL = 1e-8       # tests/test_torch_data_pipeline.py
ROW_TOL = 1e-12      # tests/test_torch_data_pipeline.py
ORACLE_TOL = 1e-9    # tests/test_torch_featurize.py
SMALL = dict(        # tests/test_torch_data_pipeline.py
    r_min_map={("W", "W"): 1.5, ("W", "W", "W"): [1.5] * 3},
    r_max_map={("W", "W"): 6.0, ("W", "W", "W"): [3.0, 3.0, 6.0]},
    resolution_map={("W", "W"): 8, ("W", "W", "W"): [4, 4, 8]})
REG = dict(c2=1e-8, c3=1e-8)
KEY_ACCENT = "données-W_3"


def frame(table, names, kinds, columns) -> pd.DataFrame:
    return pd.DataFrame(table, columns=columns,
                        index=pd.MultiIndex.from_arrays([names, kinds]))


def synthetic(rng, configs, n_atoms, columns, density=0.35, prefix="w",
              energy_only=()):
    """A feature table's DataFrame: per configuration an energy row and
    3 N force rows (none for ``energy_only``), values sparse multiples
    of 1/8, the first feature the atom count on energy rows."""
    names, kinds = [], []
    for c in configs:
        key = c if isinstance(c, str) else f"{prefix}_{c}"
        names.append(key)
        kinds.append("energy")
        if c in energy_only:
            continue
        for comp in ("fx", "fy", "fz"):
            names += [key] * n_atoms
            kinds += [f"{comp}_{a}" for a in range(n_atoms)]
    values = rng.integers(-16, 17, (len(names), len(columns))) / 8.0
    values[rng.random(values.shape) >= density] = 0.0
    energy = np.array([k == "energy" for k in kinds])
    values[:, 1] = np.where(energy, n_atoms, 0.0)
    return frame(values, names, kinds, columns)


def assert_same_table(table, df):
    """A port ``FeatureTable`` holds a DataFrame's rows bit for bit."""
    assert table.index == list(df.index)
    assert table.columns == list(df.columns)
    assert np.array_equal(table.values, df.to_numpy(dtype=np.float64))


def assert_files_agree(path, dfs):
    """``path`` holds the DataFrames ``dfs`` (name -> DataFrame), read by
    the port and by ``uf3_tpu`` (h5py)."""
    assert process.analyze_hdf_tables(path)[2] == sorted(dfs)
    ref = j_process.analyze_hdf_tables(path)
    assert process.analyze_hdf_tables(path) == ref
    for name, df in dfs.items():
        assert_same_table(process.load_feature_db(path, name), df)
        pd.testing.assert_frame_equal(j_process.load_feature_db(path, name),
                                      df, check_exact=True)


def test_reads_reference_tables_bit_for_bit(tmp_path):
    """The port reads h5py's tables: 41 tables (SNODs of 8 entries), a
    multi-level chunk B-tree with partial edge chunks, an overwritten
    table, a non-ASCII key and an energy-only configuration."""
    rng = np.random.default_rng(0)
    columns = ["y", "n_W"] + [f"WW{i}" for i in range(70)]
    path = str(tmp_path / "ref.h5")
    dfs = {}
    for t in range(41):
        configs = [KEY_ACCENT if t == 7 and c == 0 else 100 * t + c
                   for c in range(3)]
        dfs[f"features_{t:03d}"] = synthetic(
            rng, configs, 2, columns,
            energy_only=(100 * t + 1,) if t == 9 else ())
    dfs["features_040"] = synthetic(rng, range(20000 // 49 + 1), 16,
                                    columns).iloc[:20000]
    for name, df in dfs.items():
        j_process.save_feature_db(df, path, table_name=name)
    dfs["features_012"] = synthetic(rng, [1200, 1201], 3, columns)
    j_process.save_feature_db(dfs["features_012"], path,
                              table_name="features_012")
    with h5py.File(path, "r") as f:
        big = f["features_040/values"]
        assert big.shape == (20000, 72) and big.chunks == (1250, 5)
    assert_files_agree(path, dfs)
    assert process.load_feature_db(path, "features_009").select(
        ["w_901"]).kinds == ["energy"]
    assert KEY_ACCENT in process.load_feature_db(path, "features_007").names
    loaded = list(process.dataframe_batch_loader(path, ["features_001",
                                                        "features_000"]))
    assert [t.names[0] for t in loaded] == ["w_100", "w_0"]


def test_reference_reads_port_tables(tmp_path):
    """h5py and ``uf3_tpu``'s readers see the port's tables as written:
    45 tables (a B-tree over several SNODs), one of 20,000 rows (20
    chunks of whole rows), a non-ASCII key; the port's own read back."""
    rng = np.random.default_rng(1)
    columns = ["y", "n_W"] + [f"WW{i}" for i in range(70)]
    path = str(tmp_path / "port.h5")
    dfs = {}
    for t in range(44):
        dfs[f"features_{t:03d}"] = synthetic(
            rng, [KEY_ACCENT if t == 3 else 10 * t, 10 * t + 1], 2, columns)
    dfs["features_044"] = synthetic(rng, range(20000 // 49 + 1), 16,
                                    columns).iloc[:20000]
    for name, df in dfs.items():
        process.save_feature_db(process.FeatureTable(
            list(df.index), list(df.columns), df.to_numpy()), path,
            table_name=name)
    assert_files_agree(path, dfs)
    with h5py.File(path, "r") as f:
        values = f["features_044/values"]
        assert values.compression == "gzip" and values.chunks[1] == 72
        assert values.chunks[0] * 72 * 8 <= hdf5.CHUNK_BYTES
        assert [s.decode() for s in f["features_003/row_names"][()]][0] \
            == KEY_ACCENT


def _port_save(df, path, name):
    process.save_feature_db(process.FeatureTable(
        list(df.index), list(df.columns), df.to_numpy()), path,
        table_name=name)


@pytest.mark.parametrize("first", ["port", "reference"])
def test_each_appends_to_the_others_file(tmp_path, first):
    """One package writes 20 tables, the other adds 12 and replaces
    two of the first's; then the first adds one more and replaces one
    of the second's.  Both read every table."""
    rng = np.random.default_rng(2)
    columns = ["y", "n_W"] + [f"WW{i}" for i in range(9)]
    save = {"port": _port_save,
            "reference": lambda df, p, n: j_process.save_feature_db(
                df, p, table_name=n)}
    second = "reference" if first == "port" else "port"
    path = str(tmp_path / "mixed.h5")
    dfs = {}
    for t in range(20):
        dfs[f"features_{t:03d}"] = synthetic(rng, [t], 2, columns)
        save[first](dfs[f"features_{t:03d}"], path, f"features_{t:03d}")
    for t in list(range(20, 32)) + [4, 13]:
        dfs[f"features_{t:03d}"] = synthetic(rng, [t, 1000 + t], 3, columns)
        save[second](dfs[f"features_{t:03d}"], path, f"features_{t:03d}")
    for t in (32, 25):
        dfs[f"features_{t:03d}"] = synthetic(rng, [t], 1, columns)
        save[first](dfs[f"features_{t:03d}"], path, f"features_{t:03d}")
    assert_files_agree(path, dfs)


def test_cut_write_keeps_earlier_tables(tmp_path, monkeypatch):
    """A write cut before its last step (the root's index and the
    superblock unpatched) leaves the file longer than its end-of-file
    address and every earlier table readable by both packages."""
    rng = np.random.default_rng(3)
    columns = ["y", "n_W", "WW0", "WW1"]
    path = str(tmp_path / "cut.h5")
    dfs = {f"features_{t:03d}": synthetic(rng, [t], 2, columns)
           for t in range(3)}
    for name, df in dfs.items():
        _port_save(df, path, name)

    def cut(self, *args):
        raise KeyboardInterrupt

    size = os.path.getsize(path)
    monkeypatch.setattr(hdf5.File, "_commit", cut)
    with pytest.raises(KeyboardInterrupt):
        _port_save(synthetic(rng, [9], 2, columns), path, "features_003")
    monkeypatch.undo()
    assert os.path.getsize(path) > size
    with hdf5.File(path) as f:
        assert f.eof == size
    assert_files_agree(path, dfs)


@pytest.mark.parametrize("patched", [1, 2])
def test_commit_cut_between_patches(tmp_path, monkeypatch, patched):
    """A write cut inside its last step, after ``patched`` of its
    patches (the end-of-file address; then the root's symbol-table
    message), still reads in both packages: every earlier table as
    written, the new table in both or in neither.  A later write by
    either package then completes the file."""
    rng = np.random.default_rng(4)
    columns = ["y", "n_W", "WW0", "WW1"]
    path = str(tmp_path / "cut.h5")
    dfs = {f"features_{t:03d}": synthetic(rng, [t], 2, columns)
           for t in range(3)}
    for name, df in dfs.items():
        _port_save(df, path, name)
    patch, done = hdf5.File._patch, []

    def cut(self, addr, data):
        if len(done) == patched:
            raise KeyboardInterrupt
        done.append(addr)
        patch(self, addr, data)

    new = synthetic(rng, [9], 2, columns)
    monkeypatch.setattr(hdf5.File, "_patch", cut)
    with pytest.raises(KeyboardInterrupt):
        _port_save(new, path, "features_003")
    monkeypatch.undo()
    with hdf5.File(path) as f:
        assert f.eof == os.path.getsize(path)
    names = process.analyze_hdf_tables(path)[2]
    assert names == j_process.analyze_hdf_tables(path)[2]
    assert names in (sorted(dfs), sorted(dfs) + ["features_003"])
    if len(names) > len(dfs):
        dfs["features_003"] = new
    assert_files_agree(path, dfs)
    dfs["features_004"] = synthetic(rng, [10], 2, columns)
    j_process.save_feature_db(dfs["features_004"], path,
                              table_name="features_004")
    dfs["features_005"] = synthetic(rng, [11], 2, columns)
    _port_save(dfs["features_005"], path, "features_005")
    assert_files_agree(path, dfs)


def test_unsupported_structures_raise(tmp_path):
    """A superblock of version 3 (h5py ``libver="latest"``) and a
    shuffle-filtered dataset raise ``ValueError`` naming them."""
    latest, shuffled = str(tmp_path / "latest.h5"), str(tmp_path / "s.h5")
    with h5py.File(latest, "w", libver="latest") as f:
        f.create_group("t").create_dataset("values", data=np.ones((4, 2)))
    with h5py.File(shuffled, "w") as f:
        f.create_group("t").create_dataset("values", data=np.ones((40, 2)),
                                           shuffle=True, compression="gzip")
    with pytest.raises(ValueError, match="superblock version 3"):
        process.analyze_hdf_tables(latest)
    with pytest.raises(ValueError, match=r"filter id 2 \(shuffle\)"):
        process.load_feature_db(shuffled, "t")
    with pytest.raises(ValueError, match="HDF5 tables are written by"):
        io.save_features(str(tmp_path / "x.h5"), None, [], [], None, [])


# -- the featurizers' stores and the fits on them ---------------------------
def _labeled_set(n=7, seed=0):
    """Strained, rattled bcc W 2^3 cells with random labels; the fourth
    (a non-ASCII key) without forces: the port's ``Dataset`` and the
    reference's DataFrame of the same configurations, each with
    ``energy`` and ``free_energy`` columns."""
    rng = np.random.RandomState(seed)
    keys, geoms, energies, forces = [], [], [], []
    for i in range(n):
        geom = bulk("W", "bcc", a=3.1652) * 2
        geom.set_cell(geom.get_cell() * (1.0 + rng.uniform(-0.02, 0.02)),
                      scale_atoms=True)
        geom.rattle(0.08, seed=seed + i)
        keys.append(KEY_ACCENT if i == 3 else f"w_{i}")
        geoms.append(geom)
        energies.append(-12.9 * len(geom) + rng.normal())
        forces.append(None if i == 3 else rng.normal(scale=0.3,
                                                     size=(len(geom), 3)))
    columns = {"geometry": geoms, "energy": np.array(energies),
               "free_energy": np.array(energies) - 0.25}
    for c, name in enumerate(("fx", "fy", "fz")):
        columns[name] = [None if f is None else f[:, c].copy()
                         for f in forces]
    df = io.Dataset(keys, columns)
    df_ref = pd.DataFrame({
        "geometry": [JAtoms(numbers=g.numbers, positions=g.positions,
                            cell=g.cell, pbc=True) for g in geoms],
        "energy": columns["energy"], "free_energy": columns["free_energy"],
        **{name: columns[name] for name in ("fx", "fy", "fz")}},
        index=keys)
    return df, df_ref


def _tables(path):
    return {name: process.load_feature_db(path, name)
            for name in process.analyze_hdf_tables(path)[2]}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """``uf3_tpu``'s ``batched_to_hdf`` (batch size 3) and the port's on
    the host and device routes on the same set; the reference's tables
    again with their energy rows as "free_energy"; the device route's
    ``.npz`` of the same rows."""
    root = tmp_path_factory.mktemp("store")
    df, df_ref = _labeled_set()
    j_basis = JBasis(JChem(["W"], degree=3), **SMALL)
    basis = BSplineBasis(ChemicalSystem(["W"], degree=3), **SMALL)
    paths = {tag: str(root / f"{tag}.h5")
             for tag in ("ref", "host", "device", "free")}
    j_process.BasisFeaturizer(j_basis).batched_to_hdf(paths["ref"], df_ref,
                                                      batch_size=3)
    process.BasisFeaturizer(basis).batched_to_hdf(paths["host"], df,
                                                  batch_size=3)
    featurizer = tf.Featurizer(basis, device="cpu")
    stats = {}
    written = featurizer.write_features(paths["device"], df, batch_size=3,
                                        stats=stats)
    npz = str(root / "device.npz")
    featurizer.write_features(npz, df)
    for name in j_process.analyze_hdf_tables(paths["ref"])[2]:
        table = j_process.load_feature_db(paths["ref"], name)
        table.index = pd.MultiIndex.from_tuples(
            [(n, "free_energy" if k == "energy" else k)
             for n, k in table.index])
        j_process.save_feature_db(table, paths["free"], table_name=name)
    return dict(df=df, df_ref=df_ref, bases=(j_basis, basis), npz=npz,
                featurizer=featurizer, stats=stats, written=written,
                **paths)


def test_batched_to_hdf_host_and_device_routes(store):
    """The port's tables on both routes against ``uf3_tpu``'s: the same
    names (features_000..002 of 3, 2, 2 configurations), row index and
    columns; values within 1e-12 (host) and 1e-9 (device)."""
    ref = _tables(store["ref"])
    assert sorted(ref) == ["features_000", "features_001", "features_002"]
    assert store["written"] == sorted(ref) and store["stats"]["calls"] > 0
    assert store["featurizer"].route == "device"
    for tag, tol in (("host", ROW_TOL), ("device", ORACLE_TOL)):
        ours = _tables(store[tag])
        assert sorted(ours) == sorted(ref)
        for name, table in ref.items():
            assert ours[name].index == table.index
            assert ours[name].columns == table.columns
            assert np.abs(ours[name].values - table.values).max() \
                <= tol * np.abs(table.values).max()
    energy_only = ref["features_001"].select([KEY_ACCENT])
    assert energy_only.kinds == ["energy"]


def test_batched_to_hdf_rerun_and_resume(store, tmp_path, monkeypatch):
    """A rerun on a complete store adds no table and featurizes nothing
    (calls counted, the reference's ``RuntimeWarning``); a device run
    cut at its second table resumes with the missing tables alone, and
    its tables equal the uncut run's."""
    _, basis = store["bases"]
    calls = {"evaluate": 0, "batches": 0}
    evaluate, batches = process.BasisFeaturizer.evaluate, tf.featurize_batches

    def counted_evaluate(self, *args, **kwargs):
        calls["evaluate"] += 1
        return evaluate(self, *args, **kwargs)

    def counted_batches(*args, **kwargs):
        calls["batches"] += 1
        return batches(*args, **kwargs)

    monkeypatch.setattr(process.BasisFeaturizer, "evaluate",
                        counted_evaluate)
    monkeypatch.setattr(tf, "featurize_batches", counted_batches)
    before = process.analyze_hdf_tables(store["host"])
    with pytest.warns(RuntimeWarning, match="contains 3 chunks"):
        process.BasisFeaturizer(basis).batched_to_hdf(store["host"],
                                                      store["df"],
                                                      batch_size=3)
    stats = {}
    with pytest.warns(RuntimeWarning, match="contains 3 chunks"):
        assert store["featurizer"].write_features(
            store["device"], store["df"], batch_size=3, stats=stats) == []
    assert calls == {"evaluate": 0, "batches": 0}
    assert stats["skipped"] == 3 and stats["calls"] == 0
    assert process.analyze_hdf_tables(store["host"]) == before
    # cut at the second table's last step, then resumed
    path = str(tmp_path / "resumed.h5")
    commit = hdf5.File._commit
    commits = []

    def cut_second(self, *args):
        commits.append(1)
        if len(commits) == 2:
            raise KeyboardInterrupt
        commit(self, *args)

    monkeypatch.setattr(hdf5.File, "_commit", cut_second)
    with pytest.raises(KeyboardInterrupt):
        store["featurizer"].write_features(path, store["df"], batch_size=3)
    assert process.analyze_hdf_tables(path)[2] == ["features_000"]
    with h5py.File(path, "r") as f:
        assert list(f.keys()) == ["features_000"]
    monkeypatch.setattr(hdf5.File, "_commit", commit)
    calls["batches"] = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert store["featurizer"].write_features(
            path, store["df"], batch_size=3) == ["features_001",
                                                 "features_002"]
    assert calls["batches"] == 2
    full = _tables(store["device"])
    for name, table in _tables(path).items():
        assert table.index == full[name].index
        assert np.array_equal(table.values, full[name].values)
    j_process.analyze_hdf_tables(path)


def _probe(path, energy_key="energy", drop=None):
    """Every row of the reference's reading of ``path``, energies per
    atom."""
    df = pd.concat([j_process.load_feature_db(path, name) for name in
                    j_process.analyze_hdf_tables(path)[2]])
    if drop is not None:
        df = df.drop(columns=drop)
    x_e, _, x_f, _ = jls.dataframe_to_tuples(df, n_elements=1,
                                             energy_key=energy_key)
    return x_e, x_f


def _assert_same_predictions(coefficients, ref_coefficients, probe,
                             tol=FIT_TOL):
    for x in probe:
        want = x @ ref_coefficients
        assert np.abs(x @ coefficients - want).max() \
            <= tol * np.abs(want).max()


def test_fits_from_h5_match_reference(store):
    """``fit_from_file`` and ``fit_from_file_sharded`` on the
    reference's tables with sample weights, a subset spanning the three
    tables and ``energy_key="free_energy"``; dropped columns; and
    ``batched_predict``: within 1e-8 of ``uf3_tpu``'s on the same file.
    The device route's ``.h5`` fit and its ``.npz`` fit agree within
    1e-10."""
    j_basis, basis = store["bases"]
    keys = store["df"].keys
    subset = keys[1:6]
    weights = {k: 1.0 + 0.3 * (i % 4) for i, k in enumerate(keys)}
    kw = dict(subset=subset, weight=0.3, sample_weights=weights,
              energy_key="free_energy")
    ref = jls.WeightedLinearModel(j_basis, **REG)
    ref.fit_from_file(store["free"], **kw)
    ours = ls.WeightedLinearModel(basis, device="cpu", **REG)
    ours.fit_from_file(store["free"], batch_size=40, **kw)
    sharded = ls.WeightedLinearModel(basis, device="cpu", **REG)
    pmesh.fit_from_file_sharded(sharded, store["free"],
                                mesh=pmesh.ShardMesh(4, device="cpu"), **kw)
    probe = _probe(store["free"], "free_energy")
    _assert_same_predictions(ours.coefficients, ref.coefficients, probe)
    _assert_same_predictions(sharded.coefficients, ref.coefficients, probe)
    # the 3-body columns dropped, fitted in the pair basis
    pair = {k: {p: v[p] for p in v if len(p) == 2} for k, v in SMALL.items()}
    drop = [c for c in _tables(store["ref"])["features_000"].columns
            if c.startswith("WWW")]
    ref_pair = jls.WeightedLinearModel(JBasis(JChem(["W"]), **pair), **REG)
    ref_pair.fit_from_file(store["ref"], subset=keys, drop_columns=drop)
    ours_pair = ls.WeightedLinearModel(
        BSplineBasis(ChemicalSystem(["W"]), **pair), device="cpu", **REG)
    ours_pair.fit_from_file(store["ref"], subset=keys, drop_columns=drop)
    _assert_same_predictions(ours_pair.coefficients, ref_pair.coefficients,
                             _probe(store["ref"], drop=drop))
    # predictions on a subset, table by table
    ref.fit_from_file(store["ref"], subset=keys)
    ours.coefficients = ref.coefficients.copy()
    got = ours.batched_predict(store["ref"], keys=subset, score=False)
    want = ref.batched_predict(store["ref"], keys=subset, score=False)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        assert np.abs(a - b).max() <= ROW_TOL * np.abs(b).max()
    # the device route's two files
    from_h5 = ls.WeightedLinearModel(basis, device="cpu", **REG)
    from_h5.fit_from_file(store["device"], subset=keys)
    from_npz = ls.WeightedLinearModel(basis, device="cpu", **REG)
    from_npz.fit_from_file(store["npz"], subset=keys)
    x_e, _, x_f, _ = ls.feature_rows(store["npz"])
    _assert_same_predictions(from_h5.coefficients, from_npz.coefficients,
                             (x_e, x_f), tol=1e-10)
    assert ls.feature_keys(store["device"]) == keys


def test_h5_fit_holds_one_table(tmp_path):
    """The fit of a 20-table store at the bench model's width peaks
    under ``tracemalloc`` within 3x the largest table's decoded bytes
    plus the Gram matrix's."""
    basis = model_io.load_model(MODEL).bspline_config
    columns = basis.get_column_names()
    rng = np.random.default_rng(5)
    path = str(tmp_path / "twenty.h5")
    largest = 0
    for t in range(20):
        df = synthetic(rng, range(10 * t, 10 * t + 10 + t % 3), 16, columns,
                       density=0.6)
        largest = max(largest, df.to_numpy().nbytes)
        _port_save(df, path, f"features_{t:03d}")
    model = ls.WeightedLinearModel(basis, device="cpu", **REG)
    keys = ls.feature_keys(path)
    tracemalloc.start()
    try:
        model.fit_from_file(path, subset=keys)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    gram = 8 * model.n_feats ** 2
    assert np.all(np.isfinite(model.coefficients))
    assert peak <= 3 * largest + gram, (peak, largest, gram)


# -- the committed fixture ---------------------------------------------------
def write_fixture(h5_path, npz_path):
    """The fixture ``tests/data/features_ref.h5``, written by
    ``uf3_tpu``'s ``save_feature_db`` (h5py), and its ``.npz`` twin
    (``<table>.values``, ``.row_names``, ``.row_kinds``, ``.columns``):
    12 tables of 18 columns but ``features_005``, of 343 rows and 676
    columns (h5py chunks it (22, 85): 128 chunks under a two-level
    B-tree, the last row and column chunks partial; wide and short, as
    each row costs the string datasets more than its values);
    ``features_003`` written twice; a non-ASCII key in ``features_007``;
    an energy-only configuration in ``features_009``."""
    rng = np.random.default_rng(24)
    columns = ["y", "n_W"] + [f"WW{i}" for i in range(8)] + [
        f"WWW{i}" for i in range(8)]
    dfs = {}
    for t in range(12):
        configs = [KEY_ACCENT if t == 7 and c == 0 else 10 * t + c
                   for c in range(3)]
        dfs[f"features_{t:03d}"] = synthetic(
            rng, configs, 2, columns, energy_only=(91,) if t == 9 else ())
    wide = columns[:2] + [f"WWW{i}" for i in range(674)]
    dfs["features_005"] = synthetic(rng, range(50, 57), 16, wide,
                                    density=0.03)
    for name, df in dfs.items():
        j_process.save_feature_db(df, h5_path, table_name=name)
    dfs["features_003"] = synthetic(rng, [30, 31], 3, columns)
    j_process.save_feature_db(dfs["features_003"], h5_path,
                              table_name="features_003")
    arrays = {}
    for name, df in dfs.items():
        arrays[f"{name}.values"] = df.to_numpy(dtype=np.float64)
        arrays[f"{name}.row_names"] = np.array(
            [str(n) for n in df.index.get_level_values(0)])
        arrays[f"{name}.row_kinds"] = np.array(
            list(df.index.get_level_values(1)))
        arrays[f"{name}.columns"] = np.array(list(df.columns))
    np.savez_compressed(npz_path, **arrays)


def test_committed_fixture_matches_its_generator(tmp_path):
    """The committed fixture holds what ``write_fixture`` writes now
    (read by h5py and by the port), its ``.npz`` the same arrays, and
    the port reads the ``.h5`` bit-equal to the ``.npz``."""
    h5, npz = str(tmp_path / "fresh.h5"), str(tmp_path / "fresh.npz")
    write_fixture(h5, npz)
    committed = FIXTURE + ".h5"
    names = j_process.analyze_hdf_tables(h5)[2]
    assert len(names) == 12 and names == j_process.analyze_hdf_tables(
        committed)[2] == process.analyze_hdf_tables(committed)[2]
    with h5py.File(committed, "r") as f:
        big = f["features_005/values"]
        assert big.chunks == (22, 85) and big.shape == (343, 676)
    for name in names:
        pd.testing.assert_frame_equal(j_process.load_feature_db(h5, name),
                                      j_process.load_feature_db(committed,
                                                                name),
                                      check_exact=True)
    with np.load(npz) as fresh, np.load(FIXTURE + ".npz") as kept:
        assert sorted(fresh.files) == sorted(kept.files)
        for key in fresh.files:
            assert np.array_equal(fresh[key], kept[key])
        for name in names:
            table = process.load_feature_db(committed, name)
            assert np.array_equal(table.values, kept[f"{name}.values"])
            assert table.names == kept[f"{name}.row_names"].tolist()
            assert table.kinds == kept[f"{name}.row_kinds"].tolist()
            assert table.columns == kept[f"{name}.columns"].tolist()
    assert os.path.getsize(committed) + os.path.getsize(FIXTURE + ".npz") \
        <= 300_000
