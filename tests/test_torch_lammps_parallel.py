"""
The last of the reference's public surface in the port, on the CPU in
float64, against ``uf3_tpu`` on the same inputs:

- ``UFLammps(backend="lammps")`` (``uf3_tpu_torch/forcefield/lammps.py``)
  driven through a stand-in ``lammps`` module defined here, which acts
  as a LAMMPS built with ``pair_style uf3``: it records every command,
  reads the data file (refusing a box with ``hi <= lo``, as LAMMPS
  does), loads the exported ``.uf3`` file through the port's
  ``model_from_uf3_pot_file``, and evaluates energy, forces and stress
  in its own (rotated) frame with the port's ``UFCalculator`` on the
  CPU, answering in LAMMPS's units and layout.  Both packages' backends
  issue the same commands; on cells that need no rotation they return
  the same results (the port's energy carries the 1-body offsets that
  the ``.uf3`` file lacks); on every cell the port's results equal its
  native backend's in the caller's frame; the reference's rotated data
  file is refused at ``read_data`` (ROADMAP.md section 3);
- ``write_lammps_data``'s positive box lengths and rotation;
- ``BasisFeaturizer.evaluate_parallel`` (``util/parallel.py``), equal to
  ``evaluate`` and to the reference's ``evaluate_parallel``;
  ``split_dataframe``; ``gram_from_df`` and ``initialize_gram_ordinate``;
  both ``from_config``s; ``coefficients_by_interaction``;
  ``native.available``; ``df_from_tsv_text`` and ``atoms_from_df``.

The data file keeps 10 decimals (the reference's format), so LAMMPS
sees positions rounded to 5e-11 A: each geometry held to the native
backend at 1e-10 is first put where the file puts it (``as_written``),
and the raw geometry is held at the bound that rounding allows.
"""

import ast
import glob
import importlib.machinery
import os
import pickle
import re
import sys
import tempfile
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pandas as pd
import pytest
import torch

from uf3_tpu import native as j_native
from uf3_tpu.data import io as j_io
from uf3_tpu.data.atoms import Atoms as JAtoms
from uf3_tpu.data.composition import ChemicalSystem as JChem
from uf3_tpu.forcefield import calculator as j_calculator
from uf3_tpu.forcefield import lammps as j_lammps
from uf3_tpu.regression import least_squares as jls
from uf3_tpu.representation import process as j_process
from uf3_tpu.representation.basis import BSplineBasis as JBasis
from uf3_tpu.util import parallel as j_parallel
from uf3_tpu_torch import io, native
from uf3_tpu_torch.data import io as t_io
from uf3_tpu_torch.data import elements
from uf3_tpu_torch.data.atoms import Atoms, bulk
from uf3_tpu_torch.data.composition import ChemicalSystem
from uf3_tpu_torch.forcefield import calculator
from uf3_tpu_torch.forcefield import lammps
from uf3_tpu_torch.forcefield.calculator import UFCalculator
from uf3_tpu_torch.regression import least_squares as ls
from uf3_tpu_torch.representation.basis import BSplineBasis
from uf3_tpu_torch.representation.process import BasisFeaturizer
from uf3_tpu_torch.util import parallel

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "benchmarks_data", "model_2and3.json")
A_W = 3.1652
SAME_TOL = 1e-12     # the two packages' backends, same data file
NATIVE_TOL = 1e-10   # the lammps backend against the native one
# positions rounded to 5e-11 A by the data file, times the cell's
# stiffness (tens of eV/A^2): 1.0-1.2e-9 eV/A on these cells
RAW_FORCE_TOL = 1e-8
ROW_TOL = 1e-12
# 3-body legs of half the pair cutoff, as tests/test_torch_data_pipeline.py
SMALL = dict(
    r_min_map={("W", "W"): 1.5, ("W", "W", "W"): [1.5] * 3},
    r_max_map={("W", "W"): 6.0, ("W", "W", "W"): [3.0, 3.0, 6.0]},
    resolution_map={("W", "W"): 8, ("W", "W", "W"): [4, 4, 8]})


# -- the stand-in lammps module ----------------------------------------------
def read_data_file(path):
    """(cell, types, positions) of an atomic-style LAMMPS data file; a
    box with ``hi <= lo`` raises as LAMMPS does."""
    lines = [ln.strip() for ln in open(path)]
    n_atoms = int(next(ln.split()[0] for ln in lines if ln.endswith(
        " atoms")))
    cell = np.zeros((3, 3))
    for axis, tag in enumerate(("xlo xhi", "ylo yhi", "zlo zhi")):
        lo, hi = (float(v) for v in next(
            ln for ln in lines if ln.endswith(tag)).split()[:2])
        if hi <= lo:
            raise RuntimeError("ERROR: Box bounds are invalid or missing")
        cell[axis, axis] = hi - lo
    tilt = [ln for ln in lines if ln.endswith("xy xz yz")]
    if tilt:
        cell[1, 0], cell[2, 0], cell[2, 1] = (float(v) for v in
                                              tilt[0].split()[:3])
    start = lines.index("Atoms") + 2
    rows = np.array([ln.split() for ln in lines[start:start + n_atoms]],
                    dtype=float)
    order = np.argsort(rows[:, 0])
    return cell, rows[order, 1].astype(int), rows[order, 2:5]


class StandInLammps:
    """An in-process LAMMPS with ``pair_style uf3``, as far as
    ``UFLammps`` drives it.  ``faults``: command names (shared with the
    instances made after it) each of which raises once, at its next
    use."""

    def __init__(self, cmdargs=None, faults=None):
        self.cmdargs = list(cmdargs or [])
        self.faults = [] if faults is None else faults
        self.commands = []
        self.closed = False
        self._clear()

    def _clear(self):
        self.cell = self.types = self.x = self.model = None
        self.elements, self.out, self.step = [], None, 0

    def command(self, line):
        self.commands.append(line)
        word, *args = line.split()
        if word in self.faults:
            self.faults.remove(word)
            raise RuntimeError(f"ERROR: stand-in fault at {word}")
        if word == "clear":
            self._clear()
        elif word == "read_data":
            if self.cell is not None:
                raise RuntimeError("ERROR: Cannot read_data without add "
                                   "keyword after simulation box is "
                                   "defined")
            self.cell, self.types, self.x = read_data_file(args[0])
        elif word == "pair_coeff":
            self.model = lammps.model_from_uf3_pot_file(args[2])
            self.elements = args[3:]
        elif word == "run":
            self._evaluate(int(args[0]))
        elif word == "minimize":   # leaves the box and positions as they are
            self._evaluate(int(args[2]))

    def _evaluate(self, step):
        atoms = Atoms([elements.atomic_numbers[self.elements[t - 1]]
                       for t in self.types], self.x, cell=self.cell,
                      pbc=True)
        calc = UFCalculator(self.model, device="cpu")
        stress = np.asarray(calc.get_stress(atoms))
        pressure = -stress / lammps._BAR_TO_EV_A3
        self.out = dict(pe=calc.get_potential_energy(atoms),
                        f=np.asarray(calc.get_forces(atoms)),
                        vol=atoms.get_volume(), step=step,
                        **dict(zip(("pxx", "pyy", "pzz", "pyz", "pxz",
                                    "pxy"), pressure)))

    def get_natoms(self):
        return len(self.x)

    def gather_atoms(self, name, kind, count):
        assert (kind, count) == (1, 3)
        return list((self.out["f"] if name == "f" else self.x).ravel())

    def get_thermo(self, name):
        return self.out[name]

    def extract_box(self):
        (lx, _, _), (xy, ly, _), (xz, yz, lz) = self.cell
        return [0.0, 0.0, 0.0], [lx, ly, lz], xy, yz, xz, [1, 1, 1], 0

    def close(self):
        self.closed = True


@pytest.fixture
def standin(monkeypatch, tmp_path):
    """The stand-in installed as ``lammps``; both packages' temporary
    data files under ``tmp_path``; ``faults`` shared by its instances."""
    module = types.ModuleType("lammps")
    module.__spec__ = importlib.machinery.ModuleSpec("lammps", None)
    module.instances = []
    module.faults = []

    def make(cmdargs=None):
        module.instances.append(StandInLammps(cmdargs, module.faults))
        return module.instances[-1]

    module.lammps = make
    monkeypatch.setitem(sys.modules, "lammps", module)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return module


@pytest.fixture(scope="module")
def models():
    return io.load_model(MODEL), jls.WeightedLinearModel.from_json(MODEL)


# -- cells ---------------------------------------------------------------------
def rotation_111(angle):
    axis = np.ones(3) / np.sqrt(3.0)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def w_cell(kind, seed=3):
    """Rattled bcc W 2^3 (16 atoms) in a cell of ``kind``."""
    geom = bulk("W", "bcc", a=A_W) * 2
    side = 2 * A_W
    shape = {"orthogonal": np.eye(3),
             "lower-triangular": [[1, 0, 0], [0.1, 1, 0], [0.05, 0.08, 1]],
             "upper-triangular": np.array([[3, .2, .1], [0, 3, .3],
                                           [0, 0, 3]]) / 3,
             "cubic about [111]": rotation_111(0.35).T}[kind]
    geom.set_cell(side * np.asarray(shape, dtype=float), scale_atoms=True)
    geom.rattle(0.04, seed=seed)
    return geom


PLAIN = ("orthogonal", "lower-triangular")
ROTATED = ("upper-triangular", "cubic about [111]")


def as_written(geom, tmp_path):
    """``geom`` where its data file puts it (10 decimals), in its own
    frame: writing it again gives the same file."""
    first, second = str(tmp_path / "a.data"), str(tmp_path / "b.data")
    q = lammps.write_lammps_data(first, geom, ["W"])
    cell, _, x = read_data_file(first)
    out = geom.copy()
    out.set_cell(cell @ q.T)
    out.set_positions(x @ q.T)
    lammps.write_lammps_data(second, out, ["W"])
    assert open(first).read() == open(second).read()
    return out


def to_reference(geom):
    return JAtoms(numbers=geom.get_atomic_numbers(),
                  positions=geom.get_positions(), cell=geom.get_cell(),
                  pbc=True)


def one_body(geom, model):
    return len(geom) * io.arrange_coefficients(
        model.coefficients, model.bspline_config)["W"]


def normalized(commands, pot_path):
    return [re.sub(r"^read_data \S+", "read_data DATA",
                   c.replace(pot_path, "POT")) for c in commands]


def assert_results(ours, ref, tol, energy_shift=0.0):
    assert abs(ours["energy"] - ref["energy"] - energy_shift) \
        <= tol * abs(ours["energy"])
    assert ours["free_energy"] == ours["energy"]
    assert np.abs(ours["forces"] - ref["forces"]).max() <= tol
    assert np.abs(np.asarray(ours["stress"])
                  - np.asarray(ref["stress"])).max() <= tol
    assert abs(ours["volume"] - ref["volume"]) <= tol * ref["volume"]


# -- the lammps backend ------------------------------------------------------------
@pytest.mark.parametrize("kind", PLAIN)
def test_lammps_backend_matches_reference_and_native(kind, models, standin,
                                                     tmp_path):
    """Cells LAMMPS takes as they are: both packages' backends issue
    the same commands and return the same results (1e-12; the port adds
    the 1-body energy), and the port's equal its native backend's
    (1e-10)."""
    geom = as_written(w_cell(kind), tmp_path)
    ours = lammps.UFLammps(models[0], backend="lammps", device="cpu",
                           pot_dir=str(tmp_path / "port"))
    ref = j_lammps.UFLammps(models[1], backend="lammps",
                            pot_dir=str(tmp_path / "ref"))
    got = ours.evaluate(geom)
    want = ref.evaluate(to_reference(geom))
    port_lmp, ref_lmp = standin.instances
    assert normalized(port_lmp.commands, ours.pot_path) \
        == normalized(ref_lmp.commands, ref.pot_path)
    assert port_lmp.commands[-1] == "clear"
    assert port_lmp.cmdargs == ["-log", "none", "-screen", "none"]
    assert_results(got, want, SAME_TOL,
                   energy_shift=one_body(geom, models[0]))
    assert got["nsteps"] == want["nsteps"] == 0
    native_ = lammps.UFLammps(models[0], backend="native", device="cpu")
    assert_results(got, native_.evaluate(geom), NATIVE_TOL)


@pytest.mark.parametrize("kind", ROTATED)
def test_lammps_backend_rotated_cells(kind, models, standin, tmp_path):
    """Cells LAMMPS must rotate: the port's data file has positive
    box lengths and its results equal the native backend's in the
    caller's frame (1e-10; the raw geometry within the file's rounding);
    the reference's data file is refused at ``read_data``."""
    raw = w_cell(kind)
    q = lammps.write_lammps_data(str(tmp_path / "raw.data"), raw, ["W"])
    cell, _, x = read_data_file(str(tmp_path / "raw.data"))
    assert np.all(np.diag(cell) > 0) and not np.allclose(q, np.eye(3))
    assert np.abs(q @ q.T - np.eye(3)).max() < 1e-14
    assert np.abs(x @ q.T - raw.get_positions()).max() < 1e-10
    geom = as_written(raw, tmp_path)
    ours = lammps.UFLammps(models[0], backend="lammps", device="cpu",
                           pot_dir=str(tmp_path / "port"))
    native_ = lammps.UFLammps(models[0], backend="native", device="cpu")
    assert_results(ours.evaluate(geom), native_.evaluate(geom), NATIVE_TOL)
    got, want = ours.evaluate(raw), native_.evaluate(raw)
    assert np.abs(got["forces"] - want["forces"]).max() <= RAW_FORCE_TOL
    ref = j_lammps.UFLammps(models[1], backend="lammps",
                            pot_dir=str(tmp_path / "ref"))
    with pytest.raises(RuntimeError, match="(?i)box bounds"):
        ref.evaluate(to_reference(geom))


@pytest.mark.parametrize("keep_alive", [True, False])
def test_lammps_relax_writes_back_in_callers_frame(keep_alive, models,
                                                   standin, tmp_path):
    """``relax`` writes positions and cell back in the caller's
    frame (the stand-in's minimizer leaves them as they are), with the
    reference's relax commands; ``keep_alive`` clears one instance
    between calls, otherwise each call closes its own."""
    geom = as_written(w_cell("cubic about [111]"), tmp_path)
    x0, cell0 = geom.get_positions().copy(), geom.get_cell().copy()
    ours = lammps.UFLammps(models[0], backend="lammps", device="cpu",
                           keep_alive=keep_alive,
                           pot_dir=str(tmp_path / "port"))
    out = ours.relax(geom, max_steps=7)
    assert np.abs(geom.get_positions() - x0).max() <= NATIVE_TOL
    assert np.abs(geom.get_cell() - cell0).max() <= NATIVE_TOL
    assert out["nsteps"] == 7
    ours.evaluate(geom)
    first = standin.instances[0].commands
    assert first[6:9] == ["fix fix_relax all box/relax iso 0.0 vmax 0.001",
                          "min_style cg", "minimize 0.0 0.001 7 7"]
    if keep_alive:
        assert len(standin.instances) == 1
        assert [c for c in first if c in ("clear", "run 0")] \
            == ["clear", "run 0", "clear"]
        assert not standin.instances[0].closed
    else:
        assert len(standin.instances) == 2
        assert all(lmp.closed and "clear" not in lmp.commands
                   for lmp in standin.instances)


@pytest.mark.parametrize("keep_alive", [True, False])
@pytest.mark.parametrize("fault", ["read_data", "minimize"])
def test_lammps_error_path_leaves_nothing_behind(fault, keep_alive, models,
                                                 standin, tmp_path):
    """A LAMMPS command that raises (``read_data`` or ``minimize``, once)
    reaches the caller as raised, with the atoms untouched and no data
    file left; under ``keep_alive`` the kept instance is cleared, so the
    next ``evaluate`` on the same object succeeds and equals a fresh
    object's (1e-12), otherwise the instance is closed."""
    geom = w_cell("orthogonal")
    x0 = geom.get_positions().copy()
    ours = lammps.UFLammps(models[0], backend="lammps", device="cpu",
                           keep_alive=keep_alive,
                           pot_dir=str(tmp_path / "port"))
    standin.faults.append(fault)
    with pytest.raises(RuntimeError, match=f"stand-in fault at {fault}$"):
        ours.relax(geom, max_steps=7)
    assert glob.glob(str(tmp_path / "*.data")) == []
    assert np.array_equal(geom.get_positions(), x0)
    failed, = standin.instances
    assert failed.commands[-1].split()[0] == ("clear" if keep_alive
                                              else fault)
    assert failed.closed != keep_alive
    if keep_alive:
        got = ours.evaluate(geom)
        assert len(standin.instances) == 1 and not failed.closed
        fresh = lammps.UFLammps(models[0], backend="lammps", device="cpu",
                                pot_dir=str(tmp_path / "fresh"))
        assert_results(got, fresh.evaluate(geom), SAME_TOL)
        assert glob.glob(str(tmp_path / "*.data")) == []


def test_lammps_backend_refuses_what_it_cannot_run(models, standin,
                                                   monkeypatch, tmp_path):
    """A structure not periodic along every axis raises ValueError
    naming its pbc (LAMMPS would evaluate a periodic image); ``auto``
    takes the lammps backend where a ``lammps`` module is installed
    and the native one where none imports."""
    cell = w_cell("orthogonal")
    geom = Atoms(cell.get_atomic_numbers(), cell.get_positions(),
                 cell=cell.get_cell(), pbc=[True, True, False])
    ours = lammps.UFLammps(models[0], backend="lammps", device="cpu",
                           pot_dir=str(tmp_path / "port"))
    with pytest.raises(ValueError, match=r"pbc=\(True, True, False\)"):
        ours.evaluate(geom)
    assert standin.instances == []
    assert lammps.UFLammps(models[0], device="cpu",
                           pot_dir=str(tmp_path)).backend == "lammps"
    monkeypatch.setitem(sys.modules, "lammps", None)
    assert lammps.UFLammps(models[0], device="cpu").backend == "native"


# -- the host process pool -------------------------------------------------------
@pytest.fixture(scope="module")
def frames():
    """Eight bcc W 2^3 cells (16 atoms), strained and rattled, with
    random energies and forces, as both packages' tables."""
    rng = np.random.RandomState(11)
    geoms, energies, forces = [], [], []
    for _ in range(8):
        geom = bulk("W", "bcc", a=A_W) * 2
        geom.set_cell(geom.get_cell() * (1.0 + rng.uniform(-0.02, 0.02)),
                      scale_atoms=True)
        geom.rattle(0.05, seed=int(rng.randint(2 ** 31)))
        geoms.append(geom)
        energies.append(rng.uniform(-150.0, -140.0))
        forces.append(rng.normal(size=(len(geom), 3)))
    ours = t_io.prepare_dataframe_from_lists(geoms, energies=energies,
                                             forces=forces)
    ref = j_io.prepare_dataframe_from_lists(
        [to_reference(g) for g in geoms], energies=energies, forces=forces)
    return ours, ref


@pytest.fixture(scope="module")
def tables(frames):
    """``evaluate``, ``evaluate_parallel`` on two threads and the
    reference's ``evaluate_parallel`` on two threads."""
    basis = BSplineBasis(ChemicalSystem(["W"], degree=3), **SMALL)
    j_basis = JBasis(JChem(["W"], degree=3), **SMALL)
    featurizer = BasisFeaturizer(basis)
    with ThreadPoolExecutor(2) as pool:
        parallel_ = featurizer.evaluate_parallel(frames[0], client=pool,
                                                 n_jobs=2)
        ref = j_process.BasisFeaturizer(j_basis).evaluate_parallel(
            frames[1], client=pool, n_jobs=2)
    return dict(serial=featurizer.evaluate(frames[0]), parallel=parallel_,
                ref=ref, bases=(basis, j_basis))


def test_evaluate_parallel_equals_evaluate_and_reference(tables):
    """The pooled table is ``evaluate``'s bit for bit, and the
    reference's pooled DataFrame's: keys, columns, values (1e-12)."""
    serial, pooled, ref = (tables[k] for k in ("serial", "parallel", "ref"))
    assert pooled.index == serial.index and pooled.columns == serial.columns
    assert np.array_equal(pooled.values, serial.values)
    assert pooled.index == list(ref.index)
    assert pooled.columns == list(ref.columns)
    assert len(pooled) == 8 * (1 + 3 * 16)
    assert np.abs(pooled.values - ref.to_numpy()).max() \
        <= ROW_TOL * np.abs(ref.to_numpy()).max()


def test_evaluate_parallel_without_pool_and_merge(frames, tables):
    """No client, or one job, is ``evaluate``; ``gather_and_merge``
    merges dicts and arrays as the reference does, and gives an empty
    table where nothing was submitted."""
    featurizer = BasisFeaturizer(tables["bases"][0])
    few = frames[0].take([1, 0])
    for kwargs in ({}, dict(client=object(), n_jobs=1)):
        table = featurizer.evaluate_parallel(few, progress="bar", **kwargs)
        assert np.array_equal(table.values, featurizer.evaluate(few).values)
    with ThreadPoolExecutor(2) as pool:
        for items in ([{"a": 1}, {"b": 2}], [np.ones((2, 2)), np.zeros(
                (1, 2))]):
            ours = parallel.gather_and_merge(parallel.batch_submit(
                lambda item: item, items, pool))
            ref = j_parallel.gather_and_merge(j_parallel.batch_submit(
                lambda item: item, items, pool))
            if isinstance(ref, dict):
                assert ours == ref
            else:
                assert sorted(map(tuple, ours)) == sorted(map(tuple, ref))
    empty = parallel.gather_and_merge([])
    assert len(empty) == 0 and empty.columns == []


def test_unpickled_atoms_have_canonical_dtypes(frames):
    """A pool's worker unpickles its configurations: their numeric
    arrays come back on numpy's canonical dtypes (on an unpickled
    dtype, numpy 2.0's ``ufunc.at`` in the host featurizer runs ~20x
    slower), equal to the originals."""
    geom = frames[0]["geometry"][0]
    back = pickle.loads(pickle.dumps(geom))
    for name in ("numbers", "positions", "cell", "pbc"):
        value = getattr(back, name)
        assert value.dtype is np.dtype(value.dtype.type)
        assert np.array_equal(value, getattr(geom, name))
    for key, value in geom.arrays.items():
        assert back.arrays[key].dtype is np.dtype(value.dtype.type)
        assert np.array_equal(back.arrays[key], value)


@pytest.mark.parametrize("n_batches", [1, 2, 3, 4, 5])
def test_split_dataframe_matches_reference(frames, n_batches):
    ours = parallel.split_dataframe(frames[0].take(range(7)), n_batches)
    ref = j_parallel.split_dataframe(frames[1].iloc[:7], n_batches)
    assert [b.keys for b in ours] == [list(b.index) for b in ref]
    assert parallel.split_dataframe(frames[0].take([]), 3) \
        == j_parallel.split_dataframe(frames[1].iloc[:0], 3) == []


def test_progress_iter_matches_reference(capsys):
    for style in (None, "none", "text"):
        assert list(parallel.progress_iter(range(5), style=style)) \
            == list(j_parallel.progress_iter(range(5), style=style))
    assert type(parallel.progress_iter([1], style="text")).__name__ \
        == "ProgressText"
    with parallel.get_executor(1) as pool:
        assert pool._mp_context.get_start_method() == "spawn"


def test_gram_from_df_matches_reference(tables):
    """``gram_from_df`` on a subset of keys with sample weights and the
    variance recorders, summed from ``initialize_gram_ordinate``:
    the reference's arrays (1e-10 relative) and recorded variances."""
    basis, j_basis = tables["bases"]
    table, ref = tables["serial"], tables["ref"]
    keys = list(dict.fromkeys(table.names))[1:6]
    weights = {key: 1.0 + 0.1 * i for i, key in enumerate(keys)}
    model = ls.WeightedLinearModel(basis, device="cpu")
    j_model = jls.WeightedLinearModel(j_basis)
    sums, j_sums = (list(m.initialize_gram_ordinate())
                    for m in (model, j_model))
    for a, b in zip(sums, j_sums):
        assert a.shape == b.shape and not a.any()
    recorders = [ls.VarianceRecorder() for _ in range(2)]
    j_recorders = [jls.VarianceRecorder() for _ in range(2)]
    for part in (keys[:2], keys[2:]):
        got = model.gram_from_df(table, part, *recorders,
                                 sample_weights=weights, batch_size=40)
        want = j_model.gram_from_df(ref, part, *j_recorders,
                                    sample_weights=weights, batch_size=40)
        sums = [s + g for s, g in zip(sums, got)]
        j_sums = [s + w for s, w in zip(j_sums, want)]
    for a, b in zip(sums, j_sums):
        assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max()
    for r, j in zip(recorders, j_recorders):
        assert r.n == j.n and np.isclose(r.std, j.std, rtol=1e-12)


def test_from_config_matches_reference(tables, models):
    basis, j_basis = tables["bases"]
    config = {"prefix": "y", "fit_forces": False, "n_jobs": 4}
    ours = BasisFeaturizer.from_config(basis, config)
    ref = j_process.BasisFeaturizer.from_config(j_basis, config)
    assert (ours.prefix, ours.fit_forces, ours.columns) \
        == (ref.prefix, ref.fit_forces, list(ref.columns))
    config = models[1].as_dict()
    model = ls.WeightedLinearModel.from_config(config, device="cpu")
    ref_model = jls.WeightedLinearModel.from_config(config)
    assert np.array_equal(model.coefficients, ref_model.coefficients)
    assert model.bspline_config.get_column_names() \
        == ref_model.bspline_config.get_column_names()


def test_coefficients_by_interaction_matches_reference(models):
    config = models[0].bspline_config
    args = (config.element_list, config.interactions_map,
            config.partition_sizes, models[0].coefficients)
    ours = calculator.coefficients_by_interaction(*args)
    ref = j_calculator.coefficients_by_interaction(*args)
    assert list(ours) == list(ref)
    assert all(np.array_equal(ours[k], ref[k]) for k in ref)


# The reference's public names the port has under other names or does
# not port (ROADMAP.md section 1): JAX's PRNG keys, the JAX engine's
# parameter pytrees and force functions (``UF3Potential``,
# ``ops/{pair,trio,multi,factorized}.py``), the TPU's per-column row
# gather (``ops/gather.py``), the JAX de Boor values
# (``ops/spline_jax.py``'s ``deboor_values``)
NOT_PORTED_NAMES = {
    "forcefield/batch.py": {"jnp_is_typed_key"},
    "ops/neighbors.py": {"gather_rows"},
    "ops/potential.py": {
        "PotentialParams", "PotentialStatic", "build_potential",
        "compute_energy_forces", "pair_contributions",
        "pair_contributions_fast", "trio_contributions",
        "trio_contributions_factorized"},
    "ops/spline_jax.py": {"deboor_values_jax"}}
PORTED_AS = {"ops/featurize_jax.py": "ops/featurize.py",
             "ops/pallas_trio.py": "ops/trio.py"}


def public_names(path, reexports=False):
    """Top-level functions and classes (with their methods), leading
    underscores left out; with ``reexports`` also the names imported at
    module level from the port's own modules."""
    tree = ast.parse(open(path).read(), filename=path)
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{sub.name}" for sub in node.body
                           if isinstance(sub, ast.FunctionDef))
        elif reexports and isinstance(node, ast.ImportFrom) \
                and (node.module or "").startswith("uf3_tpu_torch"):
            out.update(alias.asname or alias.name for alias in node.names)
    return {name for name in out
            if not any(part.startswith("_") for part in name.split("."))}


def test_public_names_match_reference():
    """Every public function, class and method of ``uf3_tpu`` has a twin
    of the same name in the port's module of the same path, but for the
    names the port holds elsewhere or does not port."""
    root, port = os.path.join(REPO, "uf3_tpu"), os.path.join(
        REPO, "uf3_tpu_torch")
    missing = {}
    for path in glob.glob(os.path.join(root, "**", "*.py"), recursive=True):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        twin = os.path.join(port, PORTED_AS.get(rel, rel))
        assert os.path.isfile(twin), rel
        if rel not in PORTED_AS:
            gone = public_names(path) - public_names(twin, reexports=True)
            if gone:
                missing[rel] = gone
    assert missing == NOT_PORTED_NAMES
    basis = BSplineBasis(ChemicalSystem(["W"], degree=3), **SMALL)
    grid = np.random.RandomState(0).normal(size=(4, 4, 8))
    j_basis = JBasis(JChem(["W"], degree=3), **SMALL)
    for symmetry in (1, 2, 3):
        assert np.array_equal(basis.symmetrize_3B(grid[:, :, :4], symmetry),
                              j_basis.symmetrize_3B(grid[:, :, :4], symmetry))


def test_native_available(monkeypatch):
    assert native.available() is j_native.available() is True

    def fails():
        raise RuntimeError("no compiler")

    monkeypatch.setattr(native, "load", fails)
    assert native.available() is False


DUMP = """id type x y z vx tag c_pe
3 2 0.5 0.25 1.5 1 b -8.5
1 1 1.0 2.0 3.0 -2 a -8.25
2 1 4.0 5.0 6.5 3 c -8.75
"""


def test_df_from_tsv_text_and_atoms_from_df_match_reference():
    """The snapshot table keyed and sorted by ``id`` (integer, float and
    string columns), and the Atoms built from it or from a dict of its
    columns: the reference's."""
    ours, ref = t_io.df_from_tsv_text(DUMP), j_io.df_from_tsv_text(DUMP)
    assert ours.keys == list(ref.index)
    assert list(ours.columns) == list(ref.columns)
    for name in ref.columns:
        assert list(ours[name]) == list(ref[name])
        if pd.api.types.is_numeric_dtype(ref[name]):
            assert ours[name].dtype == ref[name].dtype
    aliases = {1: "W", 2: "Ne"}
    cell = np.diag([5.0, 6.0, 7.0])
    j_atoms = j_io.atoms_from_df(ref, element_key="type",
                                 lammps_aliases=aliases, info={"t": 1},
                                 cell=cell, pbc=True)
    dicts = {k: list(v) for k, v in ours.columns.items()}
    for source in (ours, dicts):
        atoms = t_io.atoms_from_df(source, element_key="type",
                                   lammps_aliases=aliases, info={"t": 1},
                                   cell=cell, pbc=True)
        assert list(atoms.numbers) == list(j_atoms.numbers) == [74, 74, 10]
        assert np.array_equal(atoms.positions, j_atoms.positions)
        assert np.array_equal(atoms.get_cell(), j_atoms.get_cell())
        assert atoms.info == j_atoms.info
        assert sorted(atoms.arrays) == sorted(j_atoms.arrays)
        for key in j_atoms.arrays:
            assert list(atoms.arrays[key]) == list(j_atoms.arrays[key])
